'''
Plain geometry operators of the reference: exact kNN, farthest point
sampling, the 1-NN distances of the sampler, fixed-capacity selection,
random point draws, scene cuboids and the evaluation grid.

A frozen copy of the plain PyTorch versions of occlusions4d_torch/ops
(knn.py, fps.py, interpolate.py, select.py, sampling.py, bounds.py), with the
kernel dispatch taken out: every function runs the same PyTorch operations
on whatever device its tensors are on. The kNN ranks by |k|^2 - 2 q.k
written as elementwise products and sums and takes ties to the lower key
index (a stable sort), which is what the port's kernels are specified to
return bit for bit; the FPS picks the first index of the maximum.
'''

from typing import NamedTuple

import numpy as np
import torch

_PLAIN_CHUNK = 2 ** 25  # distance entries per slab.


# ------------------------------------------------------------------- kNN --

def sq_norm(x):
    '''|x|^2 over the last (xyz) axis as ((x0 x0 + x1 x1) + x2 x2).'''
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def gather_neighbors(values, idx):
    '''values (B, M, D), idx (B, N, K) -> (B, N, K, D).'''
    B, N, K = idx.shape
    flat = idx.reshape(B, N * K).long()
    out = torch.gather(values, 1, flat[..., None].expand(B, N * K, values.shape[-1]))
    return out.reshape(B, N, K, values.shape[-1])


def knn_rank(q, keys, kn, k):
    '''(d (B, N, k) ranking values, idx (B, N, k) int32) of q (B, N, 3)
    among keys (B, M, 3) with squared norms kn (B, M) (+inf masked).'''
    B, N, _ = q.shape
    M = keys.shape[1]
    rows = max(1, _PLAIN_CHUNK // max(M, 1))
    ds, ids = [], []
    for r0 in range(0, N, rows):
        qc = q[:, r0:r0 + rows]
        dot = (qc[:, :, None, 0] * keys[:, None, :, 0]
               + qc[:, :, None, 1] * keys[:, None, :, 1]
               + qc[:, :, None, 2] * keys[:, None, :, 2])
        d = kn[:, None, :] - 2.0 * dot
        if k == 1 and not torch.isnan(d).any():
            vals, order = d.min(-1, keepdim=True)
        else:
            vals, order = torch.sort(d, dim=-1, stable=True)
            vals, order = vals[..., :k], order[..., :k]
        ds.append(vals)
        ids.append(torch.where(torch.isinf(vals), torch.zeros_like(order), order))
    return torch.cat(ds, 1), torch.cat(ids, 1).to(torch.int32)


def knn(query, keys, k, *, key_mask=None):
    '''The k nearest keys of each query by Euclidean distance (xyz only).
    :return (dists (..., N, k), idx (..., N, k) int32), ascending.'''
    q = query[..., :3].to(torch.float32)
    kk = keys[..., :3].to(torch.float32)
    batch_shape = q.shape[:-2]
    N, M = q.shape[-2], kk.shape[-2]
    q = q.reshape(-1, N, 3).contiguous()
    kk = kk.reshape(-1, M, 3).contiguous()
    kn = sq_norm(kk)
    if key_mask is not None:
        kn = torch.where(key_mask.reshape(-1, M).to(torch.bool), kn,
                         torch.full_like(kn, float('inf')))
    d, idx = knn_rank(q, kk, kn.contiguous(), k)
    dist = torch.sqrt(torch.clamp(d + sq_norm(q)[..., None], min=0.0))
    return dist.reshape(batch_shape + (N, k)), idx.reshape(batch_shape + (N, k))


def nn1_min_dist(query, keys, *, key_mask=None):
    '''Distance from each query to its nearest valid key. :return (..., N).'''
    d, _ = knn(query, keys, 1, key_mask=key_mask)
    return d[..., 0]


def nn1_bidirectional(a, b, *, a_mask=None, b_mask=None):
    '''(dist_a (B, N), dist_b (B, M)): each point's distance to the nearest
    valid point of the other set.'''
    a3 = a[..., :3].to(torch.float32).contiguous()
    b3 = b[..., :3].to(torch.float32).contiguous()
    B, N, _ = a3.shape
    M = b3.shape[1]
    an_true, bn_true = sq_norm(a3), sq_norm(b3)
    an = an_true if a_mask is None else torch.where(a_mask, an_true,
                                                    torch.full_like(an_true, float('inf')))
    bn = bn_true if b_mask is None else torch.where(b_mask, bn_true,
                                                    torch.full_like(bn_true, float('inf')))
    rows = max(1, _PLAIN_CHUNK // max(M, 1))
    outs_a = []
    out_b = torch.full((B, M), float('inf'), dtype=torch.float32, device=a.device)
    for r0 in range(0, N, rows):
        ac = a3[:, r0:r0 + rows]
        dot = (ac[:, :, None, 0] * b3[:, None, :, 0] + ac[:, :, None, 1] * b3[:, None, :, 1]
               + ac[:, :, None, 2] * b3[:, None, :, 2])
        t = 2.0 * dot
        outs_a.append((bn[:, None, :] - t).amin(-1))
        out_b = torch.minimum(out_b, (an[:, r0:r0 + rows, None] - t).amin(1))
    out_a = torch.cat(outs_a, 1)
    return (torch.sqrt(torch.clamp(out_a + an_true, min=0.0)),
            torch.sqrt(torch.clamp(out_b + bn_true, min=0.0)))


def inverse_distance_weights(dists, eps):
    '''(..., K) distances -> L1-normalised weights 1 / (d + eps).'''
    w = 1.0 / (dists + eps)
    return w / torch.sum(w, dim=-1, keepdim=True)


# ------------------------------------------------------------------- FPS --

def fps(xyz, n_out, start_idx=None):
    '''Farthest point sampling of (B, N, 3) points: the first pick at
    start_idx (0 by default), each later one the first index of the largest
    running minimum squared distance. :return (B, n_out) int64, ascending.'''
    xyz = xyz[..., :3].to(torch.float32).contiguous()
    B, N, _ = xyz.shape
    if start_idx is None:
        start_idx = torch.zeros((B,), dtype=torch.int64, device=xyz.device)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    min_d = torch.full((B, N), float('inf'), dtype=torch.float32, device=xyz.device)
    sel = torch.empty((B, n_out), dtype=torch.int64, device=xyz.device)
    last = start_idx.to(torch.int64).reshape(B, 1)
    sel[:, 0] = last[:, 0]
    for i in range(1, n_out):
        dx = x - torch.gather(x, 1, last)
        dy = y - torch.gather(y, 1, last)
        dz = z - torch.gather(z, 1, last)
        min_d = torch.minimum(min_d, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(min_d, dim=1, keepdim=True)
        sel[:, i] = last[:, 0]
    return torch.sort(sel, dim=-1).values


def random_start_indices(generator, batch, n_points):
    '''A uniform random FPS start per example (the training-time draw).'''
    return torch.randint(0, n_points, (batch,), generator=generator, device=generator.device)


# ------------------------------------------------------------- selection --

def valid_first_order(valid):
    '''(B, N) bool -> (B, N) int64 stable permutation, valid entries first.'''
    return torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)


def masked_choice(generator, valid, n_draw, weights=None):
    '''n_draw inverse-CDF draws per example with replacement from the valid
    entries, uniform or weighted. :return (idx (B, n) int64, ok (B,)).'''
    u = torch.rand((valid.shape[0], n_draw), generator=generator, device=valid.device)
    w = torch.where(valid, torch.ones_like(valid, dtype=torch.float32)
                    if weights is None else weights.to(torch.float32),
                    torch.zeros((), dtype=torch.float32, device=valid.device))
    ok = w.sum(-1) > 0
    cdf = torch.cummax(torch.cumsum(w, dim=-1), dim=-1).values
    last = cdf[:, -1:]
    u = u * torch.clamp(last, min=1e-30)
    u = torch.minimum(u, torch.nextafter(last, torch.zeros_like(last)))
    idx = torch.searchsorted(cdf, u.contiguous(), right=True)
    return torch.clamp(idx, max=valid.shape[-1] - 1), ok


def sample_uniform_3ball(generator, shape, max_radius, min_radius=0.0):
    '''Points in the shell [min_radius, max_radius]: gaussian direction,
    cube-root-uniform radius remapped into the shell.'''
    device = generator.device
    direction = torch.randn(tuple(shape) + (3,), generator=generator, device=device)
    norm = torch.linalg.vector_norm(direction, dim=-1, keepdim=True)
    direction = direction / torch.clamp(norm, min=1e-12)
    radius = torch.rand(tuple(shape), generator=generator, device=device) ** (1.0 / 3.0)
    radius = radius * (max_radius - min_radius) + min_radius
    return direction * radius[..., None]


def sample_blind_random(generator, shape, cuboid):
    '''Uniform points in a cuboid.'''
    device = generator.device
    u = torch.rand(tuple(shape) + (3,), generator=generator, device=device)
    lo = torch.tensor([cuboid.x_min, cuboid.y_min, cuboid.z_min], device=device)
    hi = torch.tensor([cuboid.x_max, cuboid.y_max, cuboid.z_max], device=device)
    return u * (hi - lo) + lo


# --------------------------------------------------------------- cuboids --

class Cuboid(NamedTuple):
    x_min: float
    x_max: float
    y_min: float
    y_max: float
    z_min: float
    z_max: float

    @property
    def volume(self):
        return ((self.x_max - self.x_min) * (self.y_max - self.y_min)
                * (self.z_max - self.z_min))


# CARLA's output cuboid by cube_mode: coefficients on the cube bounds for
# (x_min, x_max, y_min, y_max, z_max).
_CARLA_OUTPUT = {1: (0.0, 2.0, -1.0, 1.0, 0.5), 2: (0.0, 2.4, -0.8, 0.8, 0.4),
                 3: (0.0, 2.2, -1.0, 1.0, 0.4), 4: (0.0, 2.5, -1.0, 1.0, 0.4)}


def carla_output_bounds(other_bounds, min_z, cube_mode=4):
    cx0, cx1, cy0, cy1, cz1 = _CARLA_OUTPUT[int(cube_mode)]
    b = float(other_bounds)
    return Cuboid(b * cx0, b * cx1, b * cy0, b * cy1, float(min_z), b * cz1)


def blind_sample_bounds(data_kind, cube_bounds, min_z, cube_mode=4):
    '''The cuboid of blind queries: GREATER's symmetric cube, CARLA's output
    cuboid.'''
    if data_kind == 'greater':
        b = float(cube_bounds)
        return Cuboid(-b, b, -b, b, float(min_z), b)
    if data_kind == 'carla':
        return carla_output_bounds(cube_bounds, min_z, cube_mode)
    raise ValueError(data_kind)


def cuboid_mask(pcl, cuboid):
    '''(..., C>=3) points -> (...) bool, True inside the closed cuboid.'''
    x, y, z = pcl[..., 0], pcl[..., 1], pcl[..., 2]
    m = (cuboid.x_min <= x) & (x <= cuboid.x_max)
    m &= (cuboid.y_min <= y) & (y <= cuboid.y_max)
    m &= (cuboid.z_min <= z) & (z <= cuboid.z_max)
    return m


def grid_queries(num_sample, min_z, cube_bounds, time_idx, data_kind, cube_mode):
    '''The dense evaluation grid: a near-isotropic grid in the blind cuboid
    (x-major, z fastest), with the time column. :return (P, 4) float32.'''
    cuboid = blind_sample_bounds(data_kind, cube_bounds, min_z, cube_mode)
    per_unit = np.cbrt(num_sample / cuboid.volume)
    n = [int(np.ceil(per_unit * (hi - lo))) for lo, hi in
         ((cuboid.x_min, cuboid.x_max), (cuboid.y_min, cuboid.y_max),
          (cuboid.z_min, cuboid.z_max))]
    axes = [(np.arange(k, dtype=np.float32) + 0.5) * ((hi - lo) / k) + lo
            for k, (lo, hi) in zip(n, ((cuboid.x_min, cuboid.x_max),
                                       (cuboid.y_min, cuboid.y_max),
                                       (cuboid.z_min, cuboid.z_max)))]
    px = np.repeat(axes[0], n[1] * n[2])
    py = np.tile(np.repeat(axes[1], n[2]), n[0])
    pz = np.tile(axes[2], n[0] * n[1])
    xyz = np.stack([px, py, pz], axis=-1)
    t = np.full((xyz.shape[0], 1), float(time_idx), np.float32)
    return np.concatenate([xyz, t], axis=-1)
