'''
Host-side blind query generation for evaluation (own copy of
occlusions4d_tpu/ops/sampling.py::grid_points_numpy / blind_points_numpy; the
same points for the same arguments and rng).
'''

import numpy as np

from .bounds import Cuboid, blind_sample_bounds

__all__ = ['grid_points_numpy', 'blind_points_numpy']


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
