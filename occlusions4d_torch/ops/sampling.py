'''
Point sampling (own copy of occlusions4d_tpu/ops/sampling.py): uniform
3-ball jitter and blind queries in a cuboid on the device, from an explicit
torch.Generator, and the host-side numpy grids of evaluation (the same points
for the same arguments and rng as the JAX package).
'''

import numpy as np
import torch

from .bounds import Cuboid, blind_sample_bounds

__all__ = ['sample_uniform_3ball', 'sample_blind_random', 'grid_points_numpy',
           'blind_points_numpy']


def sample_uniform_3ball(generator, shape, max_radius, min_radius=0.0):
    '''Points in the shell [min_radius, max_radius]: gaussian direction, cube-
    root-uniform radius linearly remapped into the shell (the reference's law).
    :param shape: leading shape, e.g. (B, n). :return shape + (3,) f32.'''
    device = generator.device
    direction = torch.randn(tuple(shape) + (3,), generator=generator, device=device)
    norm = torch.linalg.vector_norm(direction, dim=-1, keepdim=True)
    direction = direction / torch.clamp(norm, min=1e-12)
    radius = torch.rand(tuple(shape), generator=generator, device=device) ** (1.0 / 3.0)
    radius = radius * (max_radius - min_radius) + min_radius
    return direction * radius[..., None]


def sample_blind_random(generator, shape, cuboid: Cuboid):
    '''Uniform points in a cuboid. :return shape + (3,) f32.'''
    device = generator.device
    u = torch.rand(tuple(shape) + (3,), generator=generator, device=device)
    lo = torch.tensor([cuboid.x_min, cuboid.y_min, cuboid.z_min], device=device)
    hi = torch.tensor([cuboid.x_max, cuboid.y_max, cuboid.z_max], device=device)
    return u * (hi - lo) + lo


def grid_points_numpy(num_sample, cuboid: Cuboid):
    '''Near-isotropic grid in a cuboid (x-major, z fastest); the count may
    deviate from the request. :return (P, 3) float32.'''
    per_unit = np.cbrt(num_sample / cuboid.volume)
    nx = int(np.ceil(per_unit * (cuboid.x_max - cuboid.x_min)))
    ny = int(np.ceil(per_unit * (cuboid.y_max - cuboid.y_min)))
    nz = int(np.ceil(per_unit * (cuboid.z_max - cuboid.z_min)))
    sx = (cuboid.x_max - cuboid.x_min) / nx
    sy = (cuboid.y_max - cuboid.y_min) / ny
    sz = (cuboid.z_max - cuboid.z_min) / nz
    px = (np.arange(nx, dtype=np.float32) + 0.5) * sx + cuboid.x_min
    py = (np.arange(ny, dtype=np.float32) + 0.5) * sy + cuboid.y_min
    pz = (np.arange(nz, dtype=np.float32) + 0.5) * sz + cuboid.z_min
    px = np.repeat(px, ny * nz)
    py = np.tile(np.repeat(py, nz), nx)
    pz = np.tile(pz, nx * ny)
    return np.stack([px, py, pz], axis=-1)


def blind_points_numpy(num_sample, min_z, cube_bounds, time_idx, data_kind,
                       cube_mode, point_sample_mode, rng=None):
    '''Blind 4D queries for evaluation. :return (P, 4) float32 (x, y, z, t).'''
    cuboid = blind_sample_bounds(data_kind, cube_bounds, min_z, cube_mode)
    if point_sample_mode == 'random':
        rng = np.random if rng is None else rng
        u = rng.rand(num_sample, 3).astype(np.float32)
        lo = np.array([cuboid.x_min, cuboid.y_min, cuboid.z_min], np.float32)
        hi = np.array([cuboid.x_max, cuboid.y_max, cuboid.z_max], np.float32)
        xyz = u * (hi - lo) + lo
    elif point_sample_mode == 'grid':
        xyz = grid_points_numpy(num_sample, cuboid)
    else:
        raise ValueError(point_sample_mode)
    t = np.full((xyz.shape[0], 1), float(time_idx), np.float32)
    return np.concatenate([xyz, t], axis=-1)
