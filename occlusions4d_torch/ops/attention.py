'''
The fused decoder operators (port of occlusions4d_tpu/ops/pallas_attention.py,
the use_idx forms that the gv1 decode runs):

  knn_extract                 shared exact kNN of the decoder queries against
                              the abstract cloud; the brute-force kNN kernel
                              (csrc/knn.cu) serves it;
  fused_knn_interp            inverse-distance interpolation, csrc/interp.cu;
  fused_knn_vector_attention  one vector cross-attention block, csrc/attn.cu,
                              in premul or per-row projection mode.

A CUDA tensor launches the kernel; a CPU tensor runs the plain version beside
it. Layouts follow the port, not the TPU: knn_extract returns (B, N, k)
arrays, not 128-lane padded tiles.
'''

import ctypes
import math

import torch

from . import _build
from .knn import _prepare, gather_neighbors, knn_rank, sq_norm

__all__ = ['knn_extract', 'fused_knn_interp', 'fused_knn_vector_attention',
           'interp_plain', 'attn_plain', 'use_premul', 'LAUNCHES']

LAUNCHES = {'interp': 0, 'attn': 0}


def knn_extract(q_pos, pos2, k, *, key_mask=None):
    '''
    Exact kNN of every query among the abstract points, shared by the
    interpolation and both attention layers of one decode.
    :param q_pos (B, N, >=3); pos2 (B, M, >=3); key_mask (B, M) bool or None.
    :return (ki (B, N, k) int32, kd (B, N, k) f32): neighbour rows, ascending,
        and squared distances d + |q|^2 (not clamped, as the TPU producer).
    '''
    q, kk, kn, _ = _prepare(q_pos, pos2, key_mask)
    d, idx = knn_rank(q, kk, kn, k)
    return idx, d + sq_norm(q)[..., None]


def _cuda_f32(name, t):
    if not (t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()):
        raise ValueError(f'{name}: expected a contiguous CUDA float32 tensor, got '
                         f'{t.device} {t.dtype} contiguous={t.is_contiguous()}')
    return t


def interp_plain(ki, kd, feats, k, eps):
    '''Plain version of the interpolation kernel.
    :param ki (B, N, >=k) int; kd (B, N, >=k) f32; feats (B, M, E).
    :return (B, N, E) f32.'''
    w = 1.0 / (torch.sqrt(torch.clamp(kd[..., :k], min=0.0)) + eps)
    g = gather_neighbors(feats, ki[..., :k])
    return (w[..., None] * g).sum(2) / w.sum(-1, keepdim=True)


def _interp_cuda(ki, kd, feats, k, eps):
    B, N, KS = ki.shape
    M, E = feats.shape[1:]
    if not (ki.is_cuda and ki.dtype == torch.int32 and ki.is_contiguous()):
        raise ValueError('interp: ki must be a contiguous CUDA int32 tensor')
    _cuda_f32('kd', kd)
    _cuda_f32('feats', feats)
    if tuple(kd.shape) != (B, N, KS) or feats.shape[0] != B or not 1 <= k <= min(KS, 32):
        raise ValueError(f'interp: bad shapes ki {tuple(ki.shape)}, kd '
                         f'{tuple(kd.shape)}, feats {tuple(feats.shape)}, k={k}')
    out = torch.empty((B, N, E), dtype=torch.float32, device=feats.device)
    fn = _build.library('interp').o4d_interp
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(feats.device):
        _build.check(fn(_build.ptr(ki), _build.ptr(kd), _build.ptr(feats),
                        _build.ptr(out), B, N, M, E, KS, k, float(eps),
                        _build.stream_ptr(feats.device)), 'interp')
    LAUNCHES['interp'] += 1
    return out


def fused_knn_interp(q_pos, pos2, feats, k, *, eps=1e-4, key_mask=None, knn=None):
    '''
    out_n = sum_j w_j f_j / sum_j w_j with w_j = 1 / (|q_n - p_j| + eps) over
    the k nearest keys.
    :param q_pos (B, N, 3); pos2 (B, M, 3); feats (B, M, E).
    :param knn: optional knn_extract(q_pos, pos2, k' >= k, key_mask) result.
    :return (B, N, E) f32.
    '''
    if knn is None:
        knn = knn_extract(q_pos, pos2, k, key_mask=key_mask)
    ki, kd = knn
    feats = feats.to(torch.float32).contiguous()
    if feats.is_cuda:
        return _interp_cuda(ki.contiguous(), kd.contiguous(), feats, k, eps)
    return interp_plain(ki, kd, feats, k, eps)


def use_premul(M, dim, feat):
    '''Projection placement rule of the TPU wrapper (pallas_attention.py:1630):
    project the key set before the gather when it is small. Kept as is until
    it is re-measured on the H100.'''
    M_pad = -(-M // 128) * 128
    return M_pad * (2 * dim - feat) < 4 * feat * dim


def _kernel(params, name):
    return params[name]['kernel'].to(torch.float32)


def attn_plain(q_pos, q_proj, ki, pos2, kv, params, k, premul):
    '''Plain version of the attention kernel (same arguments as its wrapper:
    kv is [feats2 Wk | feats2 Wv] in premul mode, else feats2).'''
    D = q_proj.shape[-1]
    idx = ki[..., :k]
    rel = q_pos[:, :, None, :] - gather_neighbors(pos2, idx)
    pe = torch.relu(rel @ _kernel(params, 'pos_mlp_0') + params['pos_mlp_0']['bias'])
    pe = pe @ _kernel(params, 'pos_mlp_2') + params['pos_mlp_2']['bias']
    g = gather_neighbors(kv, idx)
    if premul:
        kg, vg = g[..., :D], g[..., D:]
    else:
        kg, vg = g @ _kernel(params, 'to_k'), g @ _kernel(params, 'to_v')
    a = (q_proj[:, :, None, :] - kg) + pe
    h = torch.relu(a @ _kernel(params, 'attn_mlp_0') + params['attn_mlp_0']['bias'])
    lg = (h @ _kernel(params, 'attn_mlp_2') + params['attn_mlp_2']['bias'])
    lg = lg * (1.0 / math.sqrt(D))
    attn = torch.softmax(lg, dim=2)
    return (attn * (vg + pe)).sum(2)


def _attn_cuda(q_pos, q_proj, ki, pos2, kv, params, k, premul):
    B, N, D = q_proj.shape
    M = pos2.shape[1]
    KS = ki.shape[-1]
    E = kv.shape[-1] if not premul else D
    if kv.shape[-1] != (2 * D if premul else E) or kv.shape[:2] != (B, M):
        raise ValueError(f'attn: kv {tuple(kv.shape)} does not fit B={B}, M={M}, '
                         f'D={D}, premul={premul}')
    if not (ki.is_cuda and ki.dtype == torch.int32 and ki.is_contiguous()):
        raise ValueError('attn: ki must be a contiguous CUDA int32 tensor')
    if tuple(ki.shape[:2]) != (B, N) or not 1 <= k <= min(KS, 32):
        raise ValueError(f'attn: bad ki {tuple(ki.shape)} for N={N}, k={k}')
    w = {n: _cuda_f32(n, _kernel(params, n).contiguous())
         for n in ('pos_mlp_0', 'pos_mlp_2', 'attn_mlp_0', 'attn_mlp_2')}
    b = {n: _cuda_f32(n, params[n]['bias'].to(torch.float32).contiguous())
         for n in ('pos_mlp_0', 'pos_mlp_2', 'attn_mlp_0', 'attn_mlp_2')}
    P = w['pos_mlp_0'].shape[1]
    H = w['attn_mlp_0'].shape[1]
    if premul:
        wk = wv = kv  # unused by the kernel in this mode.
    else:
        wk = _cuda_f32('to_k', _kernel(params, 'to_k').contiguous())
        wv = _cuda_f32('to_v', _kernel(params, 'to_v').contiguous())
    if (w['pos_mlp_0'].shape != (3, P) or w['pos_mlp_2'].shape != (P, D)
            or w['attn_mlp_0'].shape != (D, H) or w['attn_mlp_2'].shape != (H, D)
            or (not premul and wk.shape != (E, D))):
        raise ValueError(f'attn: weight shapes do not fit D={D}, E={E}')
    lib = _build.library('attn')
    lib.o4d_attn_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.o4d_attn_smem_bytes.restype = ctypes.c_longlong
    smem = lib.o4d_attn_smem_bytes(D, E, P)
    if smem > 232448:
        raise NotImplementedError(f'attn kernel needs {smem} B of shared memory '
                                  f'at D={D}, E={E}; the H100 block limit is 232448')
    for name, t in (('q_pos', q_pos), ('q_proj', q_proj), ('pos2', pos2), ('kv', kv)):
        _cuda_f32(name, t)
    out = torch.empty((B, N, D), dtype=torch.float32, device=q_proj.device)
    fn = lib.o4d_attn
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = [q_pos, q_proj, ki, pos2, kv, wk, wv, w['pos_mlp_0'], b['pos_mlp_0'],
            w['pos_mlp_2'], b['pos_mlp_2'], w['attn_mlp_0'], b['attn_mlp_0'],
            w['attn_mlp_2'], b['attn_mlp_2'], out]
    with torch.cuda.device(q_proj.device):
        _build.check(fn(*[_build.ptr(t) for t in ptrs], B, N, M, D, E, H, P, KS, k,
                        int(premul), _build.stream_ptr(q_proj.device)), 'attn')
    LAUNCHES['attn'] += 1
    return out


def fused_knn_vector_attention(q_proj, q_pos, feats2, pos2, params, k, *,
                               key_mask=None, knn=None, premul=None):
    '''
    One fused vector cross-attention block.
    :param q_proj (B, N, D): projected queries (to_q applied).
    :param q_pos (B, N, 3); feats2 (B, M, E) raw key features; pos2 (B, M, 3).
    :param params: {'to_k', 'to_v', 'pos_mlp_0', 'pos_mlp_2', 'attn_mlp_0',
        'attn_mlp_2'}, each {'kernel' (in, out), ['bias']} torch tensors (the
        JAX package's layout).
    :param knn: optional knn_extract(q_pos, pos2, k' >= k, key_mask) result.
    :param premul (bool or None): project the key set before the gather; None
        applies use_premul.
    :return (B, N, D) f32.
    '''
    B, N, D = q_proj.shape
    M, E = feats2.shape[1:]
    if knn is None:
        knn = knn_extract(q_pos, pos2, k, key_mask=key_mask)
    ki = knn[0]
    if premul is None:
        premul = use_premul(M, D, E)
    feats2 = feats2.to(torch.float32)
    if premul:
        kv = torch.cat([feats2 @ _kernel(params, 'to_k'),
                        feats2 @ _kernel(params, 'to_v')], dim=-1)
    else:
        kv = feats2
    q_pos = q_pos[..., :3].to(torch.float32).contiguous()
    pos2 = pos2[..., :3].to(torch.float32).contiguous()
    q_proj = q_proj.to(torch.float32).contiguous()
    kv = kv.contiguous()
    if q_proj.is_cuda:
        return _attn_cuda(q_pos, q_proj, ki.contiguous(), pos2, kv, params, k, premul)
    return attn_plain(q_pos, q_proj, ki, pos2, kv, params, k, premul)
