'''
Farthest point sampling (port of occlusions4d_tpu/ops/fps.py and
ops/pallas_fps.py::fps_pallas_batched).

Semantics: n_out picks per example, the first at start_idx (0 at inference);
each later pick is the first index attaining the max of the running minimum
squared distance to the picks so far, invalid points never winning while a
valid one remains. Indices are returned sorted ascending (mirroring
`torch.sort(inds)` of the reference's DownTransition) unless sort_result is
False. A CUDA tensor launches csrc/fps.cu o4d_fps: one thread-block cluster
of 1 to 8 blocks per example, by the speed rule o4d_fps_plan measured on the
H100 (counted as 'fps' with one block, 'fps_cluster' with more); any N that
fits in device memory. A CPU tensor runs the plain loop. packed_argmax_plain
models the kernel's reduction key.
'''

import ctypes

import torch

from . import _build

__all__ = ['fps_batched', 'fps_plain', 'fps_plan', 'packed_argmax_plain',
           'random_start_indices', 'LAUNCHES']

LAUNCHES = {'fps': 0, 'fps_cluster': 0}


def fps_plain(xyz, n_out, valid, start_idx):
    '''Plain version of the FPS kernel.
    :param xyz (B, N, 3) f32; valid (B, N) bool; start_idx (B,) int.
    :return (B, n_out) int64 picks in pick order.'''
    B, N, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    min_d = torch.full((B, N), float('inf'), dtype=torch.float32, device=xyz.device)
    neg_inf = torch.full_like(min_d, float('-inf'))
    sel = torch.empty((B, n_out), dtype=torch.int64, device=xyz.device)
    last = start_idx.to(torch.int64).reshape(B, 1)
    sel[:, 0] = last[:, 0]
    for i in range(1, n_out):
        dx = x - torch.gather(x, 1, last)
        dy = y - torch.gather(y, 1, last)
        dz = z - torch.gather(z, 1, last)
        min_d = torch.minimum(min_d, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(torch.where(valid, min_d, neg_inf), dim=1, keepdim=True)
        sel[:, i] = last[:, 0]
    return sel


def packed_argmax_plain(scores, index=None):
    '''The FPS kernel's argmax in plain PyTorch: per row, the largest
    order-preserving 32-bit key of the score (csrc/fps.cu float_key: -inf
    lowest, -0 below +0, denormals in place), and among equal keys the
    largest complement of the index, i.e. the lowest index attaining the
    max. :param scores (..., N) f32; index (..., N) int64 the candidates'
    point indices (default their positions). :return (...,) int64 the
    winner's index.'''
    if index is None:
        index = torch.arange(scores.shape[-1], device=scores.device).expand(scores.shape)
    u = scores.contiguous().view(torch.int32).to(torch.int64) & 0xffffffff
    key = torch.where(u >= 2 ** 31, 0xffffffff - u, u | 2 ** 31)
    top = key.amax(-1, keepdim=True)
    nidx = 0xffffffff - index
    return 0xffffffff - torch.where(key == top, nidx, torch.zeros_like(nidx)).amax(-1)


def _fps_lib():
    lib = _build.library('fps')
    lib.o4d_fps_plan.restype = None
    lib.o4d_fps_plan.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.o4d_fps_ws_floats.restype = ctypes.c_longlong
    lib.o4d_fps_ws_floats.argtypes = [ctypes.c_int] * 3
    lib.o4d_fps.restype = ctypes.c_int
    lib.o4d_fps.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib


def fps_plan(B, N):
    '''(cluster size, threads per block) of the kernel launch for B
    examples of N points: csrc/fps.cu o4d_fps_plan.'''
    c, t = ctypes.c_int(), ctypes.c_int()
    _fps_lib().o4d_fps_plan(B, N, ctypes.byref(c), ctypes.byref(t))
    return c.value, t.value


def _fps_cuda(xyz, n_out, valid, start_idx, plan=None):
    '''The FPS kernel on the card: picks in pick order (B, n_out) int64.
    plan (cluster size, threads) overrides fps_plan's speed rule (the card
    tests run every launch shape).'''
    B, N, _ = xyz.shape
    lib = _fps_lib()
    C, T = fps_plan(B, N) if plan is None else plan
    valid = valid.to(device=xyz.device, dtype=torch.bool).contiguous()
    start = start_idx.to(device=xyz.device, dtype=torch.int32).contiguous()
    if not (xyz.is_cuda and xyz.dtype == torch.float32 and xyz.is_contiguous()):
        raise ValueError('fps: xyz must be a contiguous CUDA float32 tensor')
    if tuple(start.shape) != (B,) or tuple(valid.shape) != (B, N):
        raise ValueError(f'fps: bad start/valid shapes {tuple(start.shape)}, '
                         f'{tuple(valid.shape)} for xyz {tuple(xyz.shape)}')
    out = torch.empty((B, n_out), dtype=torch.int32, device=xyz.device)
    ws = torch.empty((max(1, lib.o4d_fps_ws_floats(B, N, T)),), dtype=torch.float32,
                     device=xyz.device)
    ptrs = [_build.ptr(t) for t in (xyz, valid, start, out, ws)]
    name = 'fps_cluster' if C > 1 else 'fps'
    with torch.cuda.device(xyz.device), _build.span(name):
        stream = _build.stream_ptr(xyz.device)
        _build.check(lib.o4d_fps(*ptrs, B, N, n_out, C, T, stream), name)
    _build.count_launch(LAUNCHES, name)
    return out.long()


def fps_batched(xyz, n_out, *, valid=None, start_idx=None, sort_result=True):
    '''
    Batched farthest point sampling.
    :param xyz (B, N, C>=3): only xyz is used.
    :param n_out (int): picks per example.
    :param valid (B, N) bool or None: invalid points are never picked.
    :param start_idx (B,) int or None (deterministic start 0).
    :return (B, n_out) int64 indices into N, sorted ascending when sort_result.
    '''
    xyz = xyz[..., :3].to(torch.float32).contiguous()
    B, N, _ = xyz.shape
    if not 1 <= n_out <= N:
        raise ValueError(f'n_out={n_out} must lie in [1, N={N}]')
    if valid is None:
        valid = torch.ones((B, N), dtype=torch.bool, device=xyz.device)
    if start_idx is None:
        start_idx = torch.zeros((B,), dtype=torch.int64, device=xyz.device)
    start_idx = torch.as_tensor(start_idx, device=xyz.device)
    if xyz.is_cuda:
        sel = _fps_cuda(xyz, n_out, valid.to(torch.bool), start_idx)
    else:
        sel = fps_plain(xyz, n_out, valid.to(torch.bool), start_idx)
    return torch.sort(sel, dim=-1).values if sort_result else sel


def random_start_indices(generator, batch, n_points, valid=None, device=None):
    '''Random FPS start per example (the training-time fps_random_start
    behaviour): uniform over [0, n_points), or uniform over the valid points
    (Gumbel-argmax, as the JAX package draws it) when a (B, N) mask is given.
    :param generator: torch.Generator on the device the indices go to.
    :return (batch,) int64.'''
    device = generator.device if device is None else device
    if valid is None:
        return torch.randint(0, n_points, (batch,), generator=generator, device=device)
    u = torch.rand((batch, n_points), generator=generator, device=device)
    g = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(torch.where(valid, g, torch.full_like(g, float('-inf'))), dim=-1)
