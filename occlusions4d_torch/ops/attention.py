'''
The fused decoder operators (port of occlusions4d_tpu/ops/pallas_attention.py,
its use_idx and gathered forms):

  knn_extract                 shared exact kNN of the decoder queries against
                              the abstract cloud; the brute-force kNN kernel
                              (csrc/knn.cu) serves it; no gradient;
  knn_gather_rows             the shared gather: the raw [feats | pos] rows of
                              every query's neighbours, once, for all the
                              consumers below (csrc/gather.cu);
                              differentiable in feats through the scatter
                              (o4d_scatter, csrc/gather.cu);
  knn_gather_interp           the shared gather and the gathered
                              interpolation as one operator, the decoder's
                              route when the abstract cloud is large
                              (models/fused.py); its backward is the scatter
                              plus the interpolation backward of its
                              cotangent (gather_interp_bwd_split);
  gather_rows                 the same gather and scatter in the n-major
                              layout of any (B, N, K) index grid (the
                              encoder's self-attention neighbours);
  fused_knn_interp            inverse-distance interpolation, csrc/interp.cu,
                              differentiable in the key features through
                              csrc/interp_bwd.cu (an inverse index by counting
                              sort, then sums per key in entry order; plain
                              version of the index: inverse_index_plain);
                              with gathered= it reads the
                              shared gather's rows (o4d_interp_g, backward
                              o4d_interp_g_bwd);
  fused_knn_vector_attention  one vector cross-attention block, csrc/attn.cu,
                              in premul or per-row projection mode,
                              differentiable in the queries, the key set and
                              every weight through csrc/attn_bwd.cu; with
                              gathered= it runs per-row over the shared
                              gather's rows (o4d_attn_g, backward
                              o4d_attn_g_bwd in csrc/attn_bwd.cu).

Every operator is a torch.autograd.Function. A CUDA tensor launches the
kernels; a CPU tensor runs the plain versions beside them (each backward
kernel has an explicit plain version with the kernel's own output layout).

compute_dtype (knn_gather_rows, knn_gather_interp, fused_knn_interp,
fused_knn_vector_attention, their plain versions and their backward
functions): torch.float32, or torch.bfloat16, the TPU kernels' bf16 compute
mode (pallas_attention.py::_mm2), which the engine's precision='fast' and the
train step's fused_decoder_dtype='bf16' run. In bf16 every in-kernel product
rounds both operands to bf16 (to nearest even: round_bf16) and sums the exact
products in f32: the attention's weights to_k, to_v, pos_mlp_* and
attn_mlp_* are rounded once (biases stay f32); the value matrix is rounded
before the gather (premul's [k | v] and the key positions, or the raw
[feats | pos] rows; so theta's input is q_pos - bf16(pos2), rounded again as
pos_mlp_0's operand); the interpolation's features and the shared gather's
rows are rounded. The kNN and its distances, the interpolation weights, the
softmax, the running sums and every output stay f32. The bf16 kernels
(o4d_attn_bf16, o4d_attn_g_bf16, o4d_interp_bf16, o4d_interp_g_bf16,
o4d_gather_bf16, and the backward ones o4d_attn_bwd_bf16,
o4d_attn_g_bwd_bf16, o4d_interp_bwd_bf16, o4d_scatter_bf16) count their
launches under their own names ('attn_bf16', ...).
The bf16 backward follows the TPU VJPs (pallas_attention.py:368-405,
538-545, 709-712, 780, 855, 928, 1107-1134, 1243-1248): every product of the
recomputed forward and of the backward (theta, k, v, h1, the transposed
products and the weight gradients' long sums) rounds both operands; the
weight kernels' gradients are rounded to bf16 once, after the whole sum (the
kernels are bf16 in the TPU kernel), the biases' stay f32, and so does
d(q_proj); the per-key sums (d(kv) of the index route, d(feats) of the
interpolation, the scatter's d(fv)) round each entry's row to bf16 before
the sum and the sum to bf16 after it. The gathered attention's row
cotangents dg stay f32 (the gather's rows are f32); on the shared-gather
route the two attention layers' dg and the interpolation's rows
(o4d_interp_g_bwd, f32, as the TPU's _interp_g_bwd_kernel) are summed in f32
and one bf16 scatter rounds that sum, the TPU order (the f32 route instead
adds interp_bwd's term after its scatter).

Like the JAX custom VJPs the index-route operators save only their inputs,
never an (N, K, D) tensor, and positions get no gradient. The shared-gather
route's backward in f32: the attention layers write their row cotangents dg
(B, k', N, E + 3) directly (o4d_attn_g_bwd; zero rows past their k and zero
position columns), autograd sums them, one scatter adds the sum to the key
rows, and the index route's interpolation backward (o4d_interp_bwd) adds the
interpolation's term from its cotangent (B, N, E), never written as rows.
The standalone fused_knn_interp(gathered=) keeps o4d_interp_g_bwd, which
writes that dense dg for autograd to add. Layouts follow the
port, not the TPU: knn_extract returns (B, N, k) arrays, not 128-lane padded
tiles, and the gather's (B, k, N, E + 3) rows are not padded to a tile grid.
'''

import ctypes
import math

import torch

from . import _build
from .knn import _prepare, gather_neighbors, knn_rank, sq_norm

__all__ = ['knn_extract', 'knn_gather_rows', 'knn_gather_interp', 'gather_rows',
           'fused_knn_interp', 'fused_knn_vector_attention', 'gather_rows_plain',
           'gather_bwd_plain', 'gather_interp_bwd_plain', 'gather_interp_bwd_split',
           'inverse_index_plain', 'key_sums_plain', 'scatter_index', 'scatter_index_plain',
           'interp_plain', 'interp_g_plain', 'interp_bwd_plain', 'interp_g_bwd_plain',
           'attn_plain', 'attn_g_plain', 'attn_bwd_plain', 'attn_g_bwd_plain',
           'attn_bwd', 'attn_g_bwd', 'attn_bwd_rows_plain', 'attn_fwd_rows_plain',
           'gather_bwd', 'interp_bwd',
           'interp_g_bwd',
           'use_premul', 'round_bf16', 'LAUNCHES']

LAUNCHES = {'interp': 0, 'attn': 0, 'interp_bwd': 0, 'attn_bwd': 0, 'gather': 0,
            'interp_g': 0, 'attn_g': 0, 'scatter': 0, 'interp_g_bwd': 0,
            'attn_g_bwd': 0, 'attn_bf16': 0, 'attn_g_bf16': 0, 'interp_bf16': 0,
            'interp_g_bf16': 0, 'gather_bf16': 0, 'attn_bwd_bf16': 0,
            'attn_g_bwd_bf16': 0, 'interp_bwd_bf16': 0, 'scatter_bf16': 0}
_MLP = ('pos_mlp_0', 'pos_mlp_2', 'attn_mlp_0', 'attn_mlp_2')
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use.
_INDEX_TILE = 2048    # entries per counting-sort tile of csrc/inverse_index.cuh (kTile).
_SUM_CHUNK = 64       # sorted entries per summing block of csrc/inverse_index.cuh (kChunk).


def round_bf16(x):
    '''x rounded to bf16 (to nearest, ties to even) in its own dtype: the
    operand rounding of the bf16 compute mode.'''
    return x.to(torch.bfloat16).to(x.dtype)


def _is_bf16(compute_dtype):
    '''True for torch.bfloat16, False for torch.float32; raises otherwise.'''
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'compute_dtype must be torch.float32 or torch.bfloat16, got '
                         f'{compute_dtype}')
    return compute_dtype == torch.bfloat16


def _rounder(bf16):
    return round_bf16 if bf16 else (lambda x: x)


def knn_extract(q_pos, pos2, k, *, key_mask=None):
    '''
    Exact kNN of every query among the abstract points, shared by the
    interpolation and both attention layers of one decode. Outside autograd:
    indices and distances carry no gradient.
    :param q_pos (B, N, >=3); pos2 (B, M, >=3); key_mask (B, M) bool or None.
    :return (ki (B, N, k) int32, kd (B, N, k) f32): neighbour rows, ascending,
        and squared distances d + |q|^2 (not clamped, as the TPU producer).
    '''
    with torch.no_grad():
        q, kk, kn, _ = _prepare(q_pos, pos2, key_mask)
        d, idx = knn_rank(q, kk, kn, k)
        return idx, d + sq_norm(q)[..., None]


def _cuda_f32(name, t):
    if not (t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()):
        raise ValueError(f'{name}: expected a contiguous CUDA float32 tensor, got '
                         f'{t.device} {t.dtype} contiguous={t.is_contiguous()}')
    return t


def _cuda_ki(name, ki):
    if not (ki.is_cuda and ki.dtype == torch.int32 and ki.is_contiguous()):
        raise ValueError(f'{name}: ki must be a contiguous CUDA int32 tensor')
    return ki


# Bytes of per-row operands one attention backward launch may hold at once
# (csrc/attn_bwd.cu cuts its rows into chunks of whole queries to fit).
_BWD_BUDGET = 1 << 30


def _bwd_plan(lib, device, N, M, D, E, H, P, k, premul):
    '''(QC, f32 workspace, int32 workspace) of one attention backward
    launch: QC queries per chunk, the same for every mode at the same sizes
    (csrc/attn_bwd.cu o4d_attn_bwd_plan), within _BWD_BUDGET bytes of
    per-row operands.'''
    qc, n_f, n_i = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_longlong()
    lib.o4d_attn_bwd_plan(N, M, D, E, H, P, k, int(premul), _BWD_BUDGET, ctypes.byref(qc),
                          ctypes.byref(n_f), ctypes.byref(n_i))
    return (qc.value, torch.empty((n_f.value,), dtype=torch.float32, device=device),
            torch.empty((max(1, n_i.value),), dtype=torch.int32, device=device))


# ------------------------------------------------------------ shared gather --

def gather_rows_plain(fv, ki, k, compute_dtype=torch.float32):
    '''Plain version of the gather kernel (bf16: of its bf16 mode, the rows
    rounded to bf16, stored as f32).
    :param fv (B, M, C) f32; ki (B, N, >=k) int. :return g (B, k, N, C).'''
    fv = _rounder(_is_bf16(compute_dtype))(fv)
    return gather_neighbors(fv, ki[..., :k]).transpose(1, 2).contiguous()


def _gather_cuda(fv, ki, k, bf16=False):
    B, N, KS = ki.shape
    M, C = fv.shape[1:]
    _cuda_ki('gather', ki)
    _cuda_f32('fv', fv)
    if fv.shape[0] != B or not 1 <= k <= min(KS, 32):
        raise ValueError(f'gather: bad shapes fv {tuple(fv.shape)}, ki '
                         f'{tuple(ki.shape)}, k={k}')
    g = torch.empty((B, k, N, C), dtype=torch.float32, device=fv.device)
    name = 'gather_bf16' if bf16 else 'gather'
    fn = getattr(_build.library('gather'), f'o4d_{name}')
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(fv.device), _build.span(name):
        _build.check(fn(_build.ptr(fv), _build.ptr(ki), _build.ptr(g), B, N, M, C, KS,
                        k, _build.stream_ptr(fv.device)), name)
    _build.count_launch(LAUNCHES, name)
    return g


def _key_sums(idx, rows, M, bf16):
    '''out[b, m] = the sum of rows[b, e] over the entries e with idx[b, e] =
    m; bf16: each row rounded to bf16 before the sum and the sum after it.
    :param idx (B, n) int; rows (B, n, C). :return (B, M, C) f32.'''
    B, n, C = rows.shape
    r = _rounder(bf16)
    out = torch.zeros((B, M, C), dtype=torch.float32, device=rows.device)
    return r(out.scatter_add_(1, idx.reshape(B, n, 1).long().expand(B, n, C), r(rows)))


def gather_bwd_plain(ki, dg, M, k, compute_dtype=torch.float32):
    '''Plain version of the scatter kernel (the gather's VJP): dfv[b, m] =
    sum of dg[b, j, n] over the rows j < k, n with ki[b, n, j] = m (bf16:
    each row rounded to bf16 before the sum, the sum after it).
    :param ki (B, N, >=k) int; dg (B, >=k, N, C) f32. :return dfv (B, M, C).'''
    B, _, N, C = dg.shape
    return _key_sums(ki[..., :k].transpose(1, 2).reshape(B, k * N),
                     dg[:, :k].reshape(B, k * N, C), M, _is_bf16(compute_dtype))


def scatter_index_plain(ki, M, k, KE):
    '''Plain version of the scatter kernel's inverse index: every key row
    (b, m) -> the rows of dg (B, KE, N, C) that add into it, in ascending row
    order (a stable sort), as (rows (B k N,) int32, offsets (B M + 1,) int32):
    key b M + m owns rows[offsets[bM+m]:offsets[bM+m+1]].'''
    B, N = ki.shape[:2]
    keys = (ki[..., :k].transpose(1, 2).reshape(B, k * N).long()
            + M * torch.arange(B, device=ki.device)[:, None]).reshape(-1)
    perm = torch.sort(keys, stable=True)[1]
    # Flat position b k N + r -> row b KE N + r of dg (KE >= k rows per b).
    rows = perm + (perm // (k * N)) * ((KE - k) * N)
    offsets = torch.zeros(B * M + 1, dtype=torch.int64, device=ki.device)
    offsets[1:] = torch.cumsum(torch.bincount(keys, minlength=B * M), 0)
    return rows.to(torch.int32), offsets.to(torch.int32)


def _scatter_lib():
    lib = _build.library('gather')
    lib.o4d_scatter_workspace.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)] * 2
    lib.o4d_scatter_workspace.restype = None
    return lib


def _scatter_workspace(lib, B, N, M, k, C, device):
    '''The scatter's int32 and f32 workspace (csrc/gather.cu).'''
    n_int, n_float = ctypes.c_longlong(), ctypes.c_longlong()
    lib.o4d_scatter_workspace(B, N, M, k, C, ctypes.byref(n_int), ctypes.byref(n_float))
    return (torch.empty((n_int.value,), dtype=torch.int32, device=device),
            torch.empty((max(1, n_float.value),), dtype=torch.float32, device=device))


def scatter_index(ki, M, k, KE):
    '''The scatter kernel's inverse index, in scatter_index_plain's layout:
    on CUDA the counting sort of csrc/inverse_index.cuh (no host sort), on
    the CPU the plain version.'''
    if not ki.is_cuda:
        return scatter_index_plain(ki, M, k, KE)
    B, N, KS = ki.shape
    ki = _cuda_ki('scatter_index', ki.contiguous())
    if not 1 <= k <= min(KS, KE, 32) or B * KE * N >= 2 ** 31:
        raise ValueError(f'scatter_index: bad shapes ki {tuple(ki.shape)}, k={k}, KE={KE}')
    lib = _scatter_lib()
    iws, _ = _scatter_workspace(lib, B, N, M, k, 1, ki.device)
    fn = lib.o4d_scatter_index
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(ki.device):
        _build.check(fn(_build.ptr(ki), _build.ptr(iws), B, N, M, KS, k,
                        _build.stream_ptr(ki.device)), 'scatter_index')
    perm = iws[B * M + 1:B * M + 1 + B * k * N].long()
    rows = perm + (perm // (k * N)) * ((KE - k) * N)
    return rows.to(torch.int32), iws[:B * M + 1].clone()


def _scatter_cuda(ki, dg, M, k, bf16=False):
    B, KE, N, C = dg.shape
    _cuda_ki('scatter', ki)
    _cuda_f32('dg', dg)
    KS = ki.shape[-1]
    if tuple(ki.shape[:2]) != (B, N) or not 1 <= k <= min(KS, KE, 32) \
            or B * KE * N >= 2 ** 31:
        raise ValueError(f'scatter: bad shapes ki {tuple(ki.shape)}, dg '
                         f'{tuple(dg.shape)}, k={k}')
    lib = _scatter_lib()
    iws, fws = _scatter_workspace(lib, B, N, M, k, C, dg.device)
    dfv = torch.empty((B, M, C), dtype=torch.float32, device=dg.device)
    name = 'scatter_bf16' if bf16 else 'scatter'
    fn = getattr(lib, f'o4d_{name}')
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dg.device), _build.span(name):
        _build.check(fn(_build.ptr(dg), _build.ptr(ki), _build.ptr(iws), _build.ptr(fws),
                        _build.ptr(dfv), B, N, M, KE, KS, k, C,
                        _build.stream_ptr(dg.device)), name)
    _build.count_launch(LAUNCHES, name)
    return dfv


def gather_bwd(ki, dg, M, k, compute_dtype=torch.float32):
    '''The gather's VJP: the scatter kernel (bf16: o4d_scatter_bf16) on
    CUDA, plain version on the CPU.'''
    dg = dg.to(torch.float32).contiguous()
    if dg.is_cuda:
        return _scatter_cuda(ki.contiguous(), dg, M, k, _is_bf16(compute_dtype))
    return gather_bwd_plain(ki, dg, M, k, compute_dtype)


def _gather(fv, ki, k, cd):
    '''The gather in compute dtype cd: its kernel on CUDA, plain version on
    the CPU.'''
    if fv.is_cuda:
        return _gather_cuda(fv, ki, k, _is_bf16(cd))
    return gather_rows_plain(fv, ki, k, cd)


class _GatherRows(torch.autograd.Function):
    '''Forward csrc/gather.cu o4d_gather, backward o4d_scatter (bf16:
    o4d_gather_bf16, o4d_scatter_bf16; plain versions on the CPU); gradient
    in fv. Saves only ki.'''

    @staticmethod
    def forward(ctx, fv, ki, k, cd):
        ctx.save_for_backward(ki)
        ctx.k, ctx.M, ctx.cd = k, fv.shape[1], cd
        return _gather(fv, ki, k, cd)

    @staticmethod
    def backward(ctx, dg):
        ki, = ctx.saved_tensors
        return gather_bwd(ki, dg, ctx.M, ctx.k, ctx.cd), None, None, None


def knn_gather_rows(pos2, feats2, knn, k, compute_dtype=torch.float32):
    '''
    The raw neighbour rows g[b, j, n] = [feats2 | pos2][b, ki[b, n, j]] for
    j < k, gathered once for every consumer of one decode (interpolation and
    attention take them through gathered=). Differentiable in feats2 in f32;
    the positions are constants.
    :param pos2 (B, M, 3); feats2 (B, M, E); knn: knn_extract result with
        k' >= k columns; k: rows to gather (>= every consumer's k).
    :param compute_dtype: torch.bfloat16 rounds the rows to bf16 (stored as
        f32, as the TPU kernel stores them); its backward is the bf16 scatter.
    :return g (B, k, N, E + 3) f32.
    '''
    fv = torch.cat([feats2.to(torch.float32),
                    pos2[..., :3].detach().to(torch.float32)], dim=-1).contiguous()
    return _GatherRows.apply(fv, knn[0].contiguous(), k, compute_dtype)


def gather_rows(values, idx):
    '''
    rows[b, n, j] = values[b, idx[b, n, j]] (n-major, as gather_neighbors),
    through the same gather kernel, differentiable in values through the
    scatter kernel: the (N, K) index grid is one column of N K rows.
    bf16 values (the encoder under mixed_precision) take the bf16 gather
    (their values exact in the f32 rows) and its VJP the bf16 scatter: each
    row's cotangent rounded to bf16, the f32 sum rounded once, where the
    JAX transpose of take_along_axis sums in bf16 in its own order.
    :param values (B, M, C) f32 or bf16; idx (B, N, K) int.
    :return (B, N, K, C) f32.
    '''
    B, N, K = idx.shape
    ki = idx.reshape(B, N * K, 1)
    if ki.is_cuda:
        ki = ki.to(torch.int32)
    cd = torch.bfloat16 if values.dtype == torch.bfloat16 else torch.float32
    g = _GatherRows.apply(values.to(torch.float32).contiguous(), ki.contiguous(), 1, cd)
    return g.reshape(B, N, K, values.shape[-1])


# ------------------------------------------------------------ interpolation --

def _interp_weights(kd, k, eps):
    return 1.0 / (torch.sqrt(torch.clamp(kd[..., :k], min=0.0)) + eps)


def _interp_rows(kd, rows, k, eps):
    '''sum_j w_j rows_j / sum_j w_j over rows (B, N, k, E).'''
    w = _interp_weights(kd, k, eps)
    return (w[..., None] * rows).sum(2) / w.sum(-1, keepdim=True)


def interp_plain(ki, kd, feats, k, eps, compute_dtype=torch.float32):
    '''Plain version of the interpolation kernel (bf16: the features
    rounded to bf16 first).
    :param ki (B, N, >=k) int; kd (B, N, >=k) f32; feats (B, M, E).
    :return (B, N, E) f32.'''
    feats = _rounder(_is_bf16(compute_dtype))(feats)
    return _interp_rows(kd, gather_neighbors(feats, ki[..., :k]), k, eps)


def interp_g_plain(kd, g, k, eps, compute_dtype=torch.float32):
    '''Plain version of the gathered interpolation kernel: interp_plain's
    arithmetic on the same rows, read from the shared gather (same bits;
    bf16: the rows' features rounded to bf16).
    :param kd (B, N, >=k) f32; g (B, >=k, N, E + 3). :return (B, N, E) f32.'''
    E = g.shape[-1] - 3
    rows = _rounder(_is_bf16(compute_dtype))(g[:, :k, :, :E])
    return _interp_rows(kd, rows.transpose(1, 2).contiguous(), k, eps)


def interp_bwd_plain(ki, kd, g, M, k, eps, compute_dtype=torch.float32):
    '''Plain version of the interpolation backward kernel: d(feats) (B, M, E)
    = sum over queries n and neighbours j of (w_nj / sum_i w_ni) g_n,
    scattered to row ki_nj (bf16: each row (w_nj / sum_i w_ni) g_n rounded
    to bf16 before the sum, the sum after it).'''
    B, N, _ = ki.shape
    E = g.shape[-1]
    w = _interp_weights(kd, k, eps)
    rows = (w / w.sum(-1, keepdim=True))[..., None] * g[:, :, None, :]
    return _key_sums(ki[..., :k].reshape(B, N * k), rows.reshape(B, N * k, E), M,
                     _is_bf16(compute_dtype))


def _interp_cuda(ki, kd, feats, k, eps, bf16=False):
    B, N, KS = ki.shape
    M, E = feats.shape[1:]
    _cuda_ki('interp', ki)
    _cuda_f32('kd', kd)
    _cuda_f32('feats', feats)
    if tuple(kd.shape) != (B, N, KS) or feats.shape[0] != B or not 1 <= k <= min(KS, 32):
        raise ValueError(f'interp: bad shapes ki {tuple(ki.shape)}, kd '
                         f'{tuple(kd.shape)}, feats {tuple(feats.shape)}, k={k}')
    out = torch.empty((B, N, E), dtype=torch.float32, device=feats.device)
    name = 'interp_bf16' if bf16 else 'interp'
    fn = getattr(_build.library('interp'), f'o4d_{name}')
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(feats.device), _build.span(name):
        _build.check(fn(_build.ptr(ki), _build.ptr(kd), _build.ptr(feats),
                        _build.ptr(out), B, N, M, E, KS, k, float(eps),
                        _build.stream_ptr(feats.device)), name)
    _build.count_launch(LAUNCHES, name)
    return out


def inverse_index_plain(ki, M, k, tile=_INDEX_TILE, jmajor=False):
    '''Plain version of the counting-sort inverse index of
    csrc/inverse_index.cuh, step by step as the kernels take them: the flat
    (B, N, k) neighbour list e = (b N + n) k + j (jmajor: the rows
    e = (b k + j) N + n of a (B, k, N, C) gather) with keys b M + ki[b, n, j],
    cut into tiles of `tile` entries; per tile, each entry's rank among the
    tile's entries of its key (the kernel sorts the unique (key, position)
    pairs of the tile) and each (key, tile)'s count; a scan of every key's
    counts over the tiles, one over the keys' totals, and the placement
    perm[offsets[key] + tile base + rank] = e.
    :return (perm (B N k,) int32: every key's entries in ascending order,
        offsets (B M + 1,) int32: key x owns perm[offsets[x]:offsets[x + 1]]).'''
    B, N = ki.shape[:2]
    dev = ki.device
    keys = ki[..., :k].long() + M * torch.arange(B, device=dev)[:, None, None]
    keys = (keys.transpose(1, 2) if jmajor else keys).reshape(-1)
    total, n_keys = keys.numel(), B * M
    T = -(-total // tile)
    e = torch.arange(total, device=dev)
    t = e // tile
    group = keys * T + t                          # (key, tile), key-major.
    cnt = torch.bincount(group, minlength=n_keys * T).view(n_keys, T)
    # The tile's entries ordered by (key, position); their sorted positions.
    order = torch.sort(t * n_keys + keys, stable=True)[1]
    pos = torch.empty_like(e)
    pos[order] = e
    first = torch.full((n_keys * T,), total, dtype=torch.int64, device=dev)
    rank = pos - first.scatter_reduce(0, group, pos, 'amin')[group]
    base = (torch.cumsum(cnt, 1) - cnt).reshape(-1)
    offsets = torch.zeros(n_keys + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(cnt.sum(1), 0)
    perm = torch.empty(total, dtype=torch.int64, device=dev)
    perm[offsets[keys] + base[group] + rank] = e
    return perm.to(torch.int32), offsets.to(torch.int32)


def key_sums_plain(rows, perm, offsets, chunk=_SUM_CHUNK):
    '''Plain version of the chunked per-key sums of csrc/inverse_index.cuh:
    the entries in index order (perm) cut into chunks of `chunk`; per chunk
    the sum of each key's run (its rows in entry order); per key the sum of
    its chunk partials in chunk order; zeros for a key no entry names.
    :param rows (entries, C) f32: entry e's row; perm, offsets: an inverse
        index (inverse_index_plain). :return (keys, C) f32.'''
    n_keys, C = offsets.numel() - 1, rows.shape[1]
    counts = torch.diff(offsets.long())
    keys = torch.repeat_interleave(torch.arange(n_keys, device=rows.device), counts)
    chunk_of = torch.arange(perm.numel(), device=rows.device) // chunk
    out = torch.zeros((n_keys, C), dtype=torch.float32, device=rows.device)
    sorted_rows = rows[perm.long()]
    for c in range(int(chunk_of.max()) + 1 if perm.numel() else 0):
        sel = chunk_of == c
        part = torch.zeros((n_keys, C), dtype=torch.float32, device=rows.device)
        for i in torch.nonzero(sel).flatten().tolist():  # entry order.
            part[keys[i]] += sorted_rows[i]
        touched = torch.unique(keys[sel])
        out[touched] += part[touched]
    return out


def _interp_bwd_launch(ki, kd, g, M, k, eps, bf16=False):
    '''The interpolation backward kernel (o4d_interp_bwd; bf16:
    o4d_interp_bwd_bf16).
    :return (dfeats (B, M, E), perm, offsets): the last two its inverse
        index, in inverse_index_plain's layout.'''
    B, N, KS = ki.shape
    E = g.shape[-1]
    _cuda_ki('interp_bwd', ki)
    _cuda_f32('kd', kd)
    _cuda_f32('g', g)
    if tuple(kd.shape) != (B, N, KS) or tuple(g.shape[:2]) != (B, N) \
            or not 1 <= k <= min(KS, 32) or B * N * k >= 2 ** 31:
        raise ValueError(f'interp_bwd: bad shapes ki {tuple(ki.shape)}, kd '
                         f'{tuple(kd.shape)}, g {tuple(g.shape)}, k={k}')
    lib = _build.library('interp_bwd')
    ws = lib.o4d_interp_bwd_workspace
    ws.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)] * 2
    ws.restype = None
    n_int, n_float = ctypes.c_longlong(), ctypes.c_longlong()
    ws(B, N, M, E, k, ctypes.byref(n_int), ctypes.byref(n_float))
    iws = torch.empty((n_int.value,), dtype=torch.int32, device=g.device)
    fws = torch.empty((max(1, n_float.value),), dtype=torch.float32, device=g.device)
    out = torch.empty((B, M, E), dtype=torch.float32, device=g.device)
    name = 'interp_bwd_bf16' if bf16 else 'interp_bwd'
    fn = getattr(lib, f'o4d_{name}')
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(g.device), _build.span(name):
        _build.check(fn(_build.ptr(ki), _build.ptr(kd), _build.ptr(g), _build.ptr(iws),
                        _build.ptr(fws), _build.ptr(out), B, N, M, E, KS, k,
                        float(eps), _build.stream_ptr(g.device)), name)
    _build.count_launch(LAUNCHES, name)
    return out, iws[B * M + 1:B * M + 1 + B * N * k], iws[:B * M + 1]


def interp_bwd(ki, kd, g, M, k, eps, compute_dtype=torch.float32):
    '''d(feats) of the interpolation: kernel B (bf16: its bf16 mode) on CUDA,
    plain version on the CPU.'''
    g = g.to(torch.float32).contiguous()
    if g.is_cuda:
        return _interp_bwd_launch(ki.contiguous(), kd.contiguous(), g, M, k, eps,
                                  _is_bf16(compute_dtype))[0]
    return interp_bwd_plain(ki, kd, g, M, k, eps, compute_dtype)


class _Interp(torch.autograd.Function):
    '''Forward csrc/interp.cu, backward csrc/interp_bwd.cu (bf16: their bf16
    modes; plain versions on the CPU); saves only ki and kd.'''

    @staticmethod
    def forward(ctx, ki, kd, feats, k, eps, cd):
        ctx.save_for_backward(ki, kd)
        ctx.k, ctx.eps, ctx.M, ctx.cd = k, eps, feats.shape[1], cd
        if feats.is_cuda:
            return _interp_cuda(ki, kd, feats, k, eps, _is_bf16(cd))
        return interp_plain(ki, kd, feats, k, eps, cd)

    @staticmethod
    def backward(ctx, g):
        ki, kd = ctx.saved_tensors
        return (None, None, interp_bwd(ki, kd, g, ctx.M, ctx.k, ctx.eps, ctx.cd), None, None,
                None)


def _interp_g_cuda(kd, g, k, eps, bf16=False):
    B, N, KS = kd.shape
    KE, E = g.shape[1], g.shape[-1] - 3
    _cuda_f32('kd', kd)
    _cuda_f32('g', g)
    if tuple(g.shape) != (B, KE, N, E + 3) or not 1 <= k <= min(KS, KE, 32):
        raise ValueError(f'interp_g: bad shapes kd {tuple(kd.shape)}, g '
                         f'{tuple(g.shape)}, k={k}')
    out = torch.empty((B, N, E), dtype=torch.float32, device=g.device)
    name = 'interp_g_bf16' if bf16 else 'interp_g'
    fn = getattr(_build.library('interp'), f'o4d_{name}')
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(g.device), _build.span(name):
        _build.check(fn(_build.ptr(kd), _build.ptr(g), _build.ptr(out), B, N, E, KS,
                        KE, k, float(eps), _build.stream_ptr(g.device)), name)
    _build.count_launch(LAUNCHES, name)
    return out


def interp_g_bwd_plain(kd, go, k, k_ext, E, eps):
    '''Plain version of the gathered interpolation's backward kernel: the
    cotangent of its rows, dg[b, j, n, :E] = (w_nj / sum_i w_ni) go[b, n]
    for j < k; the position columns and the rows j >= k are zero.
    :param kd (B, N, >=k) f32; go (B, N, E). :return dg (B, k_ext, N, E + 3).'''
    B, N = go.shape[:2]
    w = _interp_weights(kd, k, eps)
    den = w[..., 0]
    for j in range(1, k):  # summed in j order, as the TPU kernel and the CUDA one.
        den = den + w[..., j]
    wn = (w / den[..., None]).transpose(1, 2)
    dg = torch.zeros((B, k_ext, N, E + 3), dtype=torch.float32, device=go.device)
    dg[:, :k, :, :E] = wn[..., None] * go[:, None]
    return dg


def _interp_g_bwd_cuda(kd, go, k, k_ext, E, eps):
    B, N, KS = kd.shape
    _cuda_f32('kd', kd)
    _cuda_f32('go', go)
    if tuple(go.shape) != (B, N, E) or not 1 <= k <= min(KS, k_ext, 32):
        raise ValueError(f'interp_g_bwd: bad shapes kd {tuple(kd.shape)}, go '
                         f'{tuple(go.shape)}, k={k}, k_ext={k_ext}')
    dg = torch.empty((B, k_ext, N, E + 3), dtype=torch.float32, device=go.device)
    fn = _build.library('interp').o4d_interp_g_bwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(go.device), _build.span('interp_g_bwd'):
        _build.check(fn(_build.ptr(kd), _build.ptr(go), _build.ptr(dg), B, N, E, KS,
                        k_ext, k, float(eps), _build.stream_ptr(go.device)),
                     'interp_g_bwd')
    _build.count_launch(LAUNCHES, 'interp_g_bwd')
    return dg


def interp_g_bwd(kd, go, k, k_ext, E, eps):
    '''d(rows) of the gathered interpolation: its kernel on CUDA, plain
    version on the CPU.'''
    go = go.to(torch.float32).contiguous()
    if go.is_cuda:
        return _interp_g_bwd_cuda(kd.contiguous(), go, k, k_ext, E, eps)
    return interp_g_bwd_plain(kd, go, k, k_ext, E, eps)


def _interp_g(kd, g, k, eps, cd):
    '''The gathered interpolation in compute dtype cd: its kernel on CUDA,
    plain version on the CPU.'''
    if g.is_cuda:
        return _interp_g_cuda(kd, g, k, eps, _is_bf16(cd))
    return interp_g_plain(kd, g, k, eps, cd)


class _InterpG(torch.autograd.Function):
    '''Forward o4d_interp_g (bf16: o4d_interp_g_bf16), backward
    o4d_interp_g_bwd of csrc/interp.cu in both modes, as the TPU's
    _interp_g_bwd_kernel has no compute dtype (plain versions on the CPU);
    gradient in g. Saves only kd.'''

    @staticmethod
    def forward(ctx, kd, g, k, eps, cd):
        ctx.save_for_backward(kd)
        ctx.k, ctx.eps, ctx.k_ext, ctx.E = k, eps, g.shape[1], g.shape[-1] - 3
        return _interp_g(kd, g, k, eps, cd)

    @staticmethod
    def backward(ctx, go):
        kd, = ctx.saved_tensors
        return (None, interp_g_bwd(kd, go, ctx.k, ctx.k_ext, ctx.E, ctx.eps), None, None,
                None)


def gather_interp_bwd_plain(ki, kd, dg, go, M, k, k_interp, eps):
    '''Plain version of the decoder route's backward of the gather and the
    gathered interpolation (gather_interp_bwd_split): gather_bwd_plain of dg
    (None: zeros) plus, in the first E channels, interp_bwd_plain of go (the
    same sum as scattering dg + interp_g_bwd_plain(kd, go, ...)).
    :param ki, kd (B, N, >=k); dg (B, k, N, E + 3) or None; go (B, N, E).
    :return dfv (B, M, E + 3).'''
    B, N, E = go.shape
    if dg is None:
        dfv = torch.zeros((B, M, E + 3), dtype=torch.float32, device=go.device)
    else:
        dfv = gather_bwd_plain(ki, dg, M, k)
    dfv[..., :E] += interp_bwd_plain(ki, kd, go, M, k_interp, eps)
    return dfv


def gather_interp_bwd_split(ki, kd, dg, go, M, k, k_interp, eps):
    '''The decoder route's backward of the gather and the gathered
    interpolation on CUDA, gather_interp_bwd_plain's composition through
    kernels: the scatter of dg (o4d_scatter; zeros when dg is None), then the
    interpolation's backward of go (o4d_interp_bwd) added to the first E
    channels. On the H100 it is faster than folding the interpolation's term
    into the scatter (PERF.md, the kernel table).'''
    B, N, E = go.shape
    if dg is None:
        dfv = torch.zeros((B, M, E + 3), dtype=torch.float32, device=go.device)
    else:
        dfv = gather_bwd(ki, dg, M, k)
    dfv[..., :E] += interp_bwd(ki, kd, go, M, k_interp, eps)
    return dfv


class _GatherInterp(torch.autograd.Function):
    '''The shared gather and the gathered interpolation as one operator:
    forward o4d_gather then o4d_interp_g (the outputs of knn_gather_rows and
    fused_knn_interp(gathered=); bf16: o4d_gather_bf16, o4d_interp_g_bf16).
    Backward in f32: the scatter of the rows' cotangent plus the
    interpolation's backward of its own, never written as rows
    (gather_interp_bwd_split); in bf16, the TPU order: the interpolation's
    row cotangents (o4d_interp_g_bwd) added to the rows' in f32, then one
    bf16 scatter of the sum (plain versions on the CPU). Gradient in fv;
    saves ki and kd.'''

    @staticmethod
    def forward(ctx, fv, ki, kd, k, k_interp, eps, cd):
        ctx.save_for_backward(ki, kd)
        ctx.k, ctx.k_interp, ctx.eps, ctx.M, ctx.cd = k, k_interp, eps, fv.shape[1], cd
        ctx.set_materialize_grads(False)
        g = _gather(fv, ki, k, cd)
        return g, _interp_g(kd, g, k_interp, eps, cd)

    @staticmethod
    def backward(ctx, dg, go):
        ki, kd = ctx.saved_tensors
        if _is_bf16(ctx.cd):
            if go is not None:
                dgi = interp_g_bwd(kd, go, ctx.k_interp, ctx.k, go.shape[-1], ctx.eps)
                dg = dgi if dg is None else dg + dgi
            dfv = None if dg is None else gather_bwd(ki, dg, ctx.M, ctx.k, ctx.cd)
        elif go is None:
            dfv = None if dg is None else gather_bwd(ki, dg, ctx.M, ctx.k)
        elif go.is_cuda:
            dfv = gather_interp_bwd_split(ki, kd, None if dg is None else dg.contiguous(),
                                          go.contiguous(), ctx.M, ctx.k, ctx.k_interp,
                                          ctx.eps)
        else:
            dfv = gather_interp_bwd_plain(ki, kd, dg, go, ctx.M, ctx.k, ctx.k_interp,
                                          ctx.eps)
        return dfv, None, None, None, None, None, None


def knn_gather_interp(pos2, feats2, knn, k, k_interp, eps=1e-4, compute_dtype=torch.float32):
    '''
    knn_gather_rows and the gathered fused_knn_interp in one differentiable
    operator (the decoder's shared-gather route): the same outputs, and a
    backward that takes the interpolation's cotangent (B, N, E) to the key
    rows through interp_bwd instead of as (B, k, N, E + 3) row cotangents.
    :param pos2 (B, M, 3); feats2 (B, M, E); knn: knn_extract result with k'
        >= k columns; k: rows to gather; k_interp <= k: the interpolation's
        neighbours.
    :param compute_dtype: torch.bfloat16 runs both in the bf16 mode, and the
        backward in the TPU's bf16 order (_GatherInterp).
    :return (g (B, k, N, E + 3), features_local (B, N, E)) f32.
    '''
    fv = torch.cat([feats2.to(torch.float32),
                    pos2[..., :3].detach().to(torch.float32)], dim=-1).contiguous()
    return _GatherInterp.apply(fv, knn[0].contiguous(), knn[1].contiguous(), k, k_interp,
                               eps, compute_dtype)


def fused_knn_interp(q_pos, pos2, feats, k, *, eps=1e-4, key_mask=None, knn=None,
                     gathered=None, compute_dtype=torch.float32):
    '''
    out_n = sum_j w_j f_j / sum_j w_j with w_j = 1 / (|q_n - p_j| + eps) over
    the k nearest keys. Differentiable in feats (in f32).
    :param q_pos (B, N, 3); pos2 (B, M, 3); feats (B, M, E).
    :param knn: optional knn_extract(q_pos, pos2, k' >= k, key_mask) result.
    :param gathered: optional knn_gather_rows(pos2, feats, knn, k' >= k)
        result (needs knn for the distances): the rows are read from it, with
        the same result; the gradient flows back through the gather.
    :param compute_dtype: torch.bfloat16: the features rounded to bf16; the
        weights and sums stay f32; the backward in bf16 (interp_bwd_plain).
    :return (B, N, E) f32.
    '''
    if gathered is not None:
        if knn is None:
            raise ValueError('gathered= needs the knn distances')
        B, N = q_pos.shape[:2]
        E = feats.shape[-1]
        if gathered.shape[0] != B or gathered.shape[1] < k \
                or tuple(gathered.shape[2:]) != (N, E + 3):
            raise ValueError(f'gathered {tuple(gathered.shape)} does not fit B={B}, '
                             f'N={N}, E={E}, k={k}')
        return _InterpG.apply(knn[1].contiguous(), gathered.contiguous(), k, eps,
                              compute_dtype)
    if knn is None:
        knn = knn_extract(q_pos, pos2, k, key_mask=key_mask)
    ki, kd = knn
    feats = feats.to(torch.float32).contiguous()
    return _Interp.apply(ki.contiguous(), kd.contiguous(), feats, k, eps, compute_dtype)


# ---------------------------------------------------------------- attention --

def use_premul(M, dim, feat):
    '''Projection placement rule of the TPU wrapper (pallas_attention.py:1630):
    project the key set before the gather when it is small. Kept as is until
    it is re-measured on the H100.'''
    M_pad = -(-M // 128) * 128
    return M_pad * (2 * dim - feat) < 4 * feat * dim


def _kernel(params, name, dtype=torch.float32):
    return params[name]['kernel'].to(dtype)


def _attn_rows(q_pos, q_proj, kpos, rows, params, premul, bf16=False):
    '''The attention over each query's neighbour rows: kpos (B, N, k, 3),
    rows (B, N, k, 2D) projected [k | v] in premul mode, else (B, N, k, E).
    Computes in q_proj's dtype (float64 serves as a reference); bf16: every
    product's operands rounded to bf16 (the caller rounds kpos and the rows
    of premul mode).'''
    D, dt = q_proj.shape[-1], q_proj.dtype
    r = _rounder(bf16)

    def w(name):
        return r(_kernel(params, name, dt))
    rel = q_pos[:, :, None, :] - kpos
    pe = torch.relu(r(rel) @ w('pos_mlp_0') + params['pos_mlp_0']['bias'])
    pe = r(pe) @ w('pos_mlp_2') + params['pos_mlp_2']['bias']
    if premul:
        kg, vg = rows[..., :D], rows[..., D:]
    else:
        kg, vg = r(rows) @ w('to_k'), r(rows) @ w('to_v')
    a = (q_proj[:, :, None, :] - kg) + pe
    h = torch.relu(r(a) @ w('attn_mlp_0') + params['attn_mlp_0']['bias'])
    lg = (r(h) @ w('attn_mlp_2') + params['attn_mlp_2']['bias'])
    lg = lg * (1.0 / math.sqrt(D))
    attn = torch.softmax(lg, dim=2)
    return (attn * (vg + pe)).sum(2)


def attn_plain(q_pos, q_proj, ki, pos2, kv, params, k, premul,
               compute_dtype=torch.float32):
    '''Plain version of the attention kernel (same arguments as its wrapper:
    kv is [feats2 Wk | feats2 Wv] in premul mode, else feats2; bf16: kv and
    pos2 rounded to bf16 before the gather, then _attn_rows in bf16).'''
    bf16 = _is_bf16(compute_dtype)
    r = _rounder(bf16)
    idx = ki[..., :k]
    return _attn_rows(q_pos, q_proj, gather_neighbors(r(pos2), idx),
                      gather_neighbors(r(kv), idx), params, premul, bf16)


def attn_g_plain(q_pos, q_proj, g, params, k, compute_dtype=torch.float32):
    '''Plain version of the gathered attention kernel: per-row mode over the
    shared gather's rows g (B, >=k, N, E + 3); the positions carry no
    gradient (bf16: the rows rounded to bf16).'''
    bf16 = _is_bf16(compute_dtype)
    E = g.shape[-1] - 3
    rows = _rounder(bf16)(g[:, :k]).transpose(1, 2)
    return _attn_rows(q_pos, q_proj, rows[..., E:].detach().contiguous(),
                      rows[..., :E].contiguous(), params, False, bf16)


def _grad_names(premul):
    '''The differentiable weight leaves of the attention operator, in the
    order its backward returns them.'''
    names = [] if premul else [('to_k', 'kernel'), ('to_v', 'kernel')]
    for n in _MLP:
        names += [(n, 'kernel'), (n, 'bias')]
    return names


def _params(names, weights):
    '''{name: {leaf: tensor}} from _grad_names(...) and matching tensors.'''
    p = {n: {} for n in ('to_k', 'to_v') + _MLP}
    for (n, leaf), t in zip(names, weights):
        p[n][leaf] = t
    return p


def attn_bwd_plain(q_pos, q_proj, ki, pos2, kv, params, k, premul, g,
                   compute_dtype=torch.float32):
    '''Plain version of the attention backward kernel: f32 autograd through
    attn_plain; bf16 the explicit decomposition of attn_bwd_rows_plain in
    bf16 on the rows attn_plain reads (kv and pos2 rounded before the
    gather), d(kv) the per-key sums of the rows' gradients, each row rounded
    to bf16 before the sum, the sum after it.
    :return (d(q_proj), d(kv), {(name, leaf): d(weight)}).'''
    if _is_bf16(compute_dtype):
        idx = ki[..., :k]
        rel = q_pos[:, :, None, :3] - gather_neighbors(round_bf16(pos2), idx)
        rows = gather_neighbors(round_bf16(kv), idx)
        B, N = q_proj.shape[:2]
        dq, drows, dw = attn_bwd_rows_plain(q_proj, rel, rows, params, g, premul, N, 1,
                                            compute_dtype)
        dkv = _key_sums(idx.reshape(B, N * k), drows.reshape(B, N * k, -1), kv.shape[1],
                        True)
        return dq, dkv, dw
    with torch.enable_grad():
        qp = q_proj.detach().requires_grad_(True)
        kvl = kv.detach().requires_grad_(True)
        leaves = {nl: params[nl[0]][nl[1]].detach().to(torch.float32).requires_grad_(True)
                  for nl in _grad_names(premul)}
        p = _params(leaves, leaves.values())
        out = attn_plain(q_pos.detach(), qp, ki, pos2.detach(), kvl, p, k, premul)
        grads = torch.autograd.grad(out, [qp, kvl] + list(leaves.values()), g)
    return grads[0], grads[1], dict(zip(leaves, grads[2:]))


def attn_g_bwd_plain(q_pos, q_proj, g, params, k, go, compute_dtype=torch.float32):
    '''Plain version of the gathered attention's backward kernel: f32
    autograd through attn_g_plain; bf16 attn_bwd_rows_plain in bf16 on the
    rows attn_g_plain reads (the rows' cotangents stay f32, as the TPU
    kernel's dg). :return (d(q_proj), dg (B, k', N, E + 3) with zero
    position columns and zero rows j >= k, {(name, leaf): d(weight)}).'''
    if _is_bf16(compute_dtype):
        B, KE, N, C = g.shape
        rows = round_bf16(g[:, :k]).transpose(1, 2)
        rel = q_pos[:, :, None, :3] - rows[..., C - 3:]
        dq, drows, dw = attn_bwd_rows_plain(q_proj, rel, rows[..., :C - 3], params, go,
                                            False, N, 1, compute_dtype)
        dg = torch.zeros((B, KE, N, C), dtype=torch.float32, device=g.device)
        dg[:, :k, :, :C - 3] = drows.transpose(1, 2)
        return dq, dg, dw
    with torch.enable_grad():
        qp = q_proj.detach().requires_grad_(True)
        gl = g.detach().requires_grad_(True)
        leaves = {nl: params[nl[0]][nl[1]].detach().to(torch.float32).requires_grad_(True)
                  for nl in _grad_names(False)}
        p = _params(leaves, leaves.values())
        out = attn_g_plain(q_pos.detach(), qp, gl, p, k)
        grads = torch.autograd.grad(out, [qp, gl] + list(leaves.values()), go)
    return grads[0], grads[1], dict(zip(leaves, grads[2:]))


def attn_bwd_recompute_plain(q_proj, rel, rows, params, premul, k,
                             compute_dtype=torch.float32):
    '''The backward's forward recompute over the rows of some queries (row r
    = query r // k): theta's hidden layer ph = relu(rel W1 + b1), theta =
    ph W2 + b2, the rows' k and v (premul: the rows are [k | v]; per-row:
    F Wk and F Wv), hpre = (q - k) + theta, v + theta and relu(h1) =
    relu(hpre A1 + c1); bf16: each product's operands rounded to bf16.
    :param q_proj (n, D); rel (n k, 3); rows (n k, 2D | E).
    :return dict(ph, th, kk, vpe, hp, r1), each (n k, .).'''
    r = _rounder(_is_bf16(compute_dtype))
    D = q_proj.shape[-1]

    def w(name):
        return r(_kernel(params, name))

    def b(name):
        return params[name]['bias'].to(torch.float32)
    ph = torch.relu(r(rel) @ w('pos_mlp_0') + b('pos_mlp_0'))
    th = r(ph) @ w('pos_mlp_2') + b('pos_mlp_2')
    if premul:
        kk, vv = rows[:, :D], rows[:, D:]
    else:
        kk, vv = r(rows) @ w('to_k'), r(rows) @ w('to_v')
    hp = (q_proj.repeat_interleave(k, 0) - kk) + th
    r1 = torch.relu(r(hp) @ w('attn_mlp_0') + b('attn_mlp_0'))
    return dict(ph=ph, th=th, kk=kk, vpe=vv + th, hp=hp, r1=r1)


def attn_bwd_rows_plain(q_proj, rel, rows, params, go, premul, qc, slices=2,
                        compute_dtype=torch.float32):
    '''The backward kernels' decomposition (csrc/attn_bwd.cu) in plain
    PyTorch, on the rows of every query whatever the route: per chunk of qc
    queries of one example, the row phase (the forward recomputed, the
    softmax backward, dh1, dhpre, dtheta, dtheta_h, d(q_proj) and the rows'
    gradients), then the chunk's weight gradients as sums over its rows cut
    into `slices` slices, the slices added in order and the chunks in chunk
    order. bf16 (o4d_attn_bwd_bf16's arithmetic): every product's operands
    rounded to bf16, the recomputed forward's (attn_bwd_recompute_plain),
    the transposed products' and the weight gradients' sums; the weight
    kernels' gradients rounded to bf16 after the whole sum, the biases' and
    d(q_proj) f32, the rows' gradients f32 (each route rounds them where it
    sums them).
    :param q_proj (B, N, D); rel (B, N, k, 3) = q_pos - the keys' positions;
        rows (B, N, k, 2D) projected [k | v] in premul mode, else the raw
        features F (B, N, k, E); go (B, N, D) = d(out).
    :return (d(q_proj) (B, N, D), the rows' gradients (B, N, k, 2D | E),
        {(name, leaf): d(weight)}).'''
    bf16 = _is_bf16(compute_dtype)
    r = _rounder(bf16)
    B, N, k, _ = rel.shape
    D = q_proj.shape[-1]
    w = {n: r(_kernel(params, n)) for n in _MLP}
    bias = {n: params[n]['bias'].to(torch.float32) for n in _MLP}
    wk = None if premul else r(_kernel(params, 'to_k'))
    wv = None if premul else r(_kernel(params, 'to_v'))
    names = _grad_names(premul)
    grads = {nl: None for nl in names}
    dq = torch.empty_like(q_proj, dtype=torch.float32)
    drows = torch.empty(rows.shape, dtype=torch.float32, device=rows.device)

    def add(nl, parts):
        '''The chunk's slice partials added in order, then to the sum.'''
        s = parts[0]
        for p in parts[1:]:
            s = s + p
        grads[nl] = s if grads[nl] is None else grads[nl] + s

    for b in range(B):
        for n0 in range(0, N, qc):
            n1 = min(N, n0 + qc)
            nq = n1 - n0
            R = nq * k
            rl = rel[b, n0:n1].reshape(R, 3)
            x = rows[b, n0:n1].reshape(R, -1)
            # Row phase: the forward recomputed.
            fw = attn_bwd_recompute_plain(q_proj[b, n0:n1], rl, x, params, premul, k,
                                          compute_dtype)
            ph, th, hp, vpe, r1 = fw['ph'], fw['th'], fw['hp'], fw['vpe'], fw['r1']
            lg = (r(r1) @ w['attn_mlp_2'] + bias['attn_mlp_2']) / math.sqrt(D)
            a = torch.softmax(lg.view(nq, k, D), dim=1)
            gq = go[b, n0:n1, None, :]
            vq = vpe.view(nq, k, D)
            s = (a * gq * vq).sum(1, keepdim=True)
            dlog = (a * (gq * vq - s) / math.sqrt(D)).reshape(R, D)
            dv = (a * gq).reshape(R, D)
            dh = (r(dlog) @ w['attn_mlp_2'].T) * (r1 > 0)
            dhp = r(dh) @ w['attn_mlp_0'].T
            dq[b, n0:n1] = dhp.view(nq, k, D).sum(1)
            dth = dhp + dv
            dph = (r(dth) @ w['pos_mlp_2'].T) * (ph > 0)
            if premul:
                drow = torch.cat([-dhp, dv], dim=-1)
            else:
                drow = r(dv) @ wv.T - r(dhp) @ wk.T
            drows[b, n0:n1] = drow.view(nq, k, -1)
            # Weight-gradient phase: long-K sums over the chunk's rows.
            cuts = [(R * i) // slices for i in range(slices + 1)]
            pieces = [slice(cuts[i], cuts[i + 1]) for i in range(slices)]
            ops = {('attn_mlp_0', 'kernel'): (hp, dh), ('attn_mlp_2', 'kernel'): (r1, dlog),
                   ('pos_mlp_2', 'kernel'): (ph, dth), ('pos_mlp_0', 'kernel'): (rl, dph)}
            if not premul:
                ops[('to_k', 'kernel')] = (x, -dhp)
                ops[('to_v', 'kernel')] = (x, dv)
            for nl, (X, Y) in ops.items():
                X, Y = r(X), r(Y)
                add(nl, [X[p].T @ Y[p] for p in pieces])
            for n, Y in (('attn_mlp_0', dh), ('attn_mlp_2', dlog), ('pos_mlp_2', dth),
                         ('pos_mlp_0', dph)):
                add((n, 'bias'), [Y[p].sum(0) for p in pieces])
    if bf16:
        grads = {nl: round_bf16(v) if nl[1] == 'kernel' else v for nl, v in grads.items()}
    return dq, drows, grads


def attn_fwd_rows_plain(q_proj, rel, rows, params, premul, qc, product=None,
                        compute_dtype=torch.float32):
    '''The forward kernels' decomposition (csrc/attn.cu o4d_attn, o4d_attn_g
    and o4d_sattn) in plain PyTorch, on the rows of every query whatever the
    route: per chunk of qc queries of one example, theta from rel, the rows'
    k and v (premul: the rows are [k | v]; per-row: F Wk and F Wv), hpre =
    (q - k) + theta; per tile of 64 rows, gamma in chunks of 128 hidden
    columns, h = relu(hpre A1[:, chunk] + c1[chunk]) and logits += h
    A2[chunk], the logits one running sum across the chunks; then per query
    and channel the softmax over its k rows and the weighted sum of v +
    theta, each summed in j order.
    :param q_proj (B, N, D); rel (B, N, k, 3) = q_pos - the keys' positions
        (the self-attention's coordinate deltas as given); rows (B, N, k, 2D)
        projected [k | v] in premul mode, else the raw features F (B, N, k, E).
    :param product: (a, b, c) -> c + a b for the products the kernel runs on
        the tensor cores (c None: a b); default the f32 matrix product.
    :param compute_dtype: torch.bfloat16, the kernels' bf16 mode: both
        operands of every product rounded to bf16 (rel, theta's hidden
        layer, F, hpre, h and the weight kernels), every sum f32.
    :return (B, N, D) in q_proj's dtype (the weights cast to it).'''
    if product is None:
        def product(a, b, c):
            return a @ b if c is None else c + a @ b
    r = _rounder(_is_bf16(compute_dtype))
    tile, hc = 64, 128  # the kernel's rows per tile and hidden columns per chunk.
    B, N, k, _ = rel.shape
    D, dt, dev = q_proj.shape[-1], q_proj.dtype, q_proj.device
    w = {n: r(params[n]['kernel'].to(dt)) for n in _MLP + ('to_k', 'to_v')
         if n in params and not (premul and n in ('to_k', 'to_v'))}
    bias = {n: params[n]['bias'].to(dt) for n in _MLP}
    H = w['attn_mlp_0'].shape[1]
    out = torch.empty((B, N, D), dtype=dt, device=dev)
    for b in range(B):
        for n0 in range(0, N, qc):
            n1 = min(N, n0 + qc)
            nq = n1 - n0
            R = nq * k
            rl = rel[b, n0:n1].reshape(R, 3)
            x = rows[b, n0:n1].reshape(R, -1)
            th = r(torch.relu(r(rl) @ w['pos_mlp_0'] + bias['pos_mlp_0'])) @ w['pos_mlp_2'] \
                + bias['pos_mlp_2']
            if premul:
                kk, vv = x[:, :D], x[:, D:]
            else:
                kk = product(r(x), w['to_k'], None)
                vv = product(r(x), w['to_v'], None)
            hp = r((q_proj[b, n0:n1].repeat_interleave(k, 0) - kk) + th)
            lg = torch.empty((R, D), dtype=dt, device=dev)
            for t0 in range(0, R, tile):
                a, acc = hp[t0:t0 + tile], None
                for h0 in range(0, H, hc):
                    h = torch.relu(product(a, w['attn_mlp_0'][:, h0:h0 + hc], None)
                                   + bias['attn_mlp_0'][h0:h0 + hc])
                    acc = product(r(h), w['attn_mlp_2'][h0:h0 + hc], acc)
                lg[t0:t0 + tile] = acc
            lg = ((lg + bias['attn_mlp_2']) * (1.0 / math.sqrt(D))).view(nq, k, D)
            vpe = (vv + th).view(nq, k, D)
            mx = lg.max(dim=1).values
            den = torch.zeros((nq, D), dtype=dt, device=dev)
            acc = torch.zeros_like(den)
            for j in range(k):
                e = torch.exp(lg[:, j] - mx)
                den = den + e
                acc = acc + e * vpe[:, j]
            out[b, n0:n1] = acc / den
    return out


def _attn_lib():
    '''The forward kernels' library, its size queries typed.'''
    lib = _build.library('attn')
    lib.o4d_attn_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.o4d_attn_smem_bytes.restype = ctypes.c_longlong
    lib.o4d_attn_max_width.argtypes = []
    lib.o4d_attn_max_width.restype = ctypes.c_int
    out = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)]
    lib.o4d_attn_plan.restype = lib.o4d_sattn_plan.restype = None
    lib.o4d_attn_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.c_longlong] + out
    lib.o4d_sattn_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.c_longlong] + out
    return lib


# Bytes of per-row operands one attention forward launch may hold at once
# (csrc/attn.cu cuts its rows into chunks of whole queries to fit).
_FWD_BUDGET = 1 << 30


def _fwd_plan(lib, what, device, N, D, E, H, P, k, premul, self_rows=False):
    '''(QC, f32 workspace) of one o4d_attn / o4d_attn_g launch (self_rows:
    o4d_sattn / o4d_sattn_bf16): QC queries per chunk (csrc/attn.cu
    o4d_attn_plan, o4d_sattn_plan), the chunk's per-row operands within
    _FWD_BUDGET bytes; the workspace also holds the weights in fragment
    order. Raises NotImplementedError for widths the tile does not take:
    max(D, E) above o4d_attn_max_width() (560, where the tile's rows fill
    the block's shared memory; D above 416 runs in column blocks).'''
    width = lib.o4d_attn_max_width()
    smem = lib.o4d_attn_smem_bytes(D, E, P)
    if max(D, E) > width or smem > _SMEM_LIMIT:
        raise NotImplementedError(f'{what} kernel takes D and E up to {width} (and '
                                  f'{_SMEM_LIMIT} B of shared memory, it needs {smem}); '
                                  f'got D={D}, E={E}')
    qc, n_f = ctypes.c_int(), ctypes.c_longlong()
    if self_rows:
        lib.o4d_sattn_plan(N, D, E, H, P, k, _FWD_BUDGET, ctypes.byref(qc), ctypes.byref(n_f))
    else:
        lib.o4d_attn_plan(N, D, E, H, P, k, int(premul), _FWD_BUDGET, ctypes.byref(qc),
                          ctypes.byref(n_f))
    return qc.value, torch.empty((n_f.value,), dtype=torch.float32, device=device)


def _attn_operands(q_pos, q_proj, ki, pos2, kv, params, k, premul, bf16=False):
    '''Checked, contiguous operands shared by the forward and backward
    kernels: (dims dict, weight dict, bias dict, wk, wv).'''
    B, N, D = q_proj.shape
    M = pos2.shape[1]
    KS = ki.shape[-1]
    E = kv.shape[-1] if not premul else D
    if kv.shape[-1] != (2 * D if premul else E) or kv.shape[:2] != (B, M):
        raise ValueError(f'attn: kv {tuple(kv.shape)} does not fit B={B}, M={M}, '
                         f'D={D}, premul={premul}')
    _cuda_ki('attn', ki)
    if tuple(ki.shape[:2]) != (B, N) or not 1 <= k <= min(KS, 32):
        raise ValueError(f'attn: bad ki {tuple(ki.shape)} for N={N}, k={k}')
    w, b, wk, wv, H, P = _weight_operands(params, D, E, premul, kv, bf16)
    for name, t in (('q_pos', q_pos), ('q_proj', q_proj), ('pos2', pos2), ('kv', kv)):
        _cuda_f32(name, t)
    dims = dict(B=B, N=N, M=M, D=D, E=E, H=H, P=P, KS=KS)
    return dims, w, b, wk, wv


def _weight_operands(params, D, E, premul, kv=None, bf16=False):
    '''Checked, contiguous attention weights: (weight dict, bias dict, wk, wv,
    H, P); in premul mode wk and wv are placeholders (kv). bf16: the kernels
    rounded to bf16 (the biases stay f32).'''
    r = _rounder(bf16)
    w = {n: _cuda_f32(n, r(_kernel(params, n)).contiguous()) for n in _MLP}
    b = {n: _cuda_f32(n, params[n]['bias'].to(torch.float32).contiguous()) for n in _MLP}
    P = w['pos_mlp_0'].shape[1]
    H = w['attn_mlp_0'].shape[1]
    if premul:
        wk = wv = kv  # unused by the kernels in this mode.
    else:
        wk = _cuda_f32('to_k', r(_kernel(params, 'to_k')).contiguous())
        wv = _cuda_f32('to_v', r(_kernel(params, 'to_v')).contiguous())
    if (w['pos_mlp_0'].shape != (3, P) or w['pos_mlp_2'].shape != (P, D)
            or w['attn_mlp_0'].shape != (D, H) or w['attn_mlp_2'].shape != (H, D)
            or (not premul and wk.shape != (E, D))):
        raise ValueError(f'attn: weight shapes do not fit D={D}, E={E}')
    return w, b, wk, wv, H, P


def _weight_ptrs(w, b):
    return [w['pos_mlp_0'], b['pos_mlp_0'], w['pos_mlp_2'], b['pos_mlp_2'],
            w['attn_mlp_0'], b['attn_mlp_0'], w['attn_mlp_2'], b['attn_mlp_2']]


def _attn_cuda(q_pos, q_proj, ki, pos2, kv, params, k, premul, bf16=False):
    dims, w, b, wk, wv = _attn_operands(q_pos, q_proj, ki, pos2, kv, params, k, premul, bf16)
    B, N, D = dims['B'], dims['N'], dims['D']
    lib = _attn_lib()
    QC, ws = _fwd_plan(lib, 'attn', q_proj.device, N, D, dims['E'], dims['H'], dims['P'],
                       k, premul)
    out = torch.empty((B, N, D), dtype=torch.float32, device=q_proj.device)
    name = 'attn_bf16' if bf16 else 'attn'
    fn = getattr(lib, f'o4d_{name}')
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = [q_pos, q_proj, ki, pos2, kv, wk, wv] + _weight_ptrs(w, b) + [out, ws]
    with torch.cuda.device(q_proj.device), _build.span(name):
        _build.check(fn(*[_build.ptr(t) for t in ptrs], B, N, dims['M'], D, dims['E'],
                        dims['H'], dims['P'], dims['KS'], k, int(premul), QC,
                        _build.stream_ptr(q_proj.device)), name)
    _build.count_launch(LAUNCHES, name)
    return out


def _attn_g_cuda(q_pos, q_proj, g, params, k, bf16=False):
    B, N, D = q_proj.shape
    KE, E = g.shape[1], g.shape[-1] - 3
    if tuple(g.shape) != (B, KE, N, E + 3) or not 1 <= k <= min(KE, 32):
        raise ValueError(f'attn_g: g {tuple(g.shape)} does not fit B={B}, N={N}, '
                         f'k={k}')
    w, b, wk, wv, H, P = _weight_operands(params, D, E, False, bf16=bf16)
    for name, t in (('q_pos', q_pos), ('q_proj', q_proj), ('g', g)):
        _cuda_f32(name, t)
    lib = _attn_lib()
    # The same chunks as the index route's per-row mode at these sizes.
    QC, ws = _fwd_plan(lib, 'attn_g', q_proj.device, N, D, E, H, P, k, False)
    out = torch.empty((B, N, D), dtype=torch.float32, device=q_proj.device)
    name = 'attn_g_bf16' if bf16 else 'attn_g'
    fn = getattr(lib, f'o4d_{name}')
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = [q_pos, q_proj, g, wk, wv] + _weight_ptrs(w, b) + [out, ws]
    with torch.cuda.device(q_proj.device), _build.span(name):
        _build.check(fn(*[_build.ptr(t) for t in ptrs], B, N, D, E, H, P, KE, k, QC,
                        _build.stream_ptr(q_proj.device)), name)
    _build.count_launch(LAUNCHES, name)
    return out


def _attn_bwd_cuda(q_pos, q_proj, ki, pos2, kv, params, k, premul, g, bf16=False):
    dims, w, b, wk, wv = _attn_operands(q_pos, q_proj, ki, pos2, kv, params, k, premul,
                                        bf16)
    B, N, M, D, E, H, P = (dims[x] for x in 'BNMDEHP')
    _cuda_f32('g', g)
    if tuple(g.shape) != (B, N, D):
        raise ValueError(f'attn_bwd: g {tuple(g.shape)} does not fit {(B, N, D)}')
    lib = _attn_bwd_lib()
    n_w = lib.o4d_attn_bwd_weight_floats(D, E, H, P, int(premul))
    dev = q_proj.device
    QC, ws, iws = _bwd_plan(lib, dev, N, M, D, E, H, P, k, premul)
    dq = torch.empty((B, N, D), dtype=torch.float32, device=dev)
    dw = torch.empty((n_w,), dtype=torch.float32, device=dev)
    dkv = torch.empty(kv.shape, dtype=torch.float32, device=dev)
    name = 'attn_bwd_bf16' if bf16 else 'attn_bwd'
    fn = getattr(lib, f'o4d_{name}')
    fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = ([q_pos, q_proj, ki, pos2, kv, wk, wv] + _weight_ptrs(w, b)
            + [g, dq, dw, dkv, ws, iws])
    with torch.cuda.device(dev), _build.span(name):
        _build.check(fn(*[_build.ptr(t) for t in ptrs], B, N, M, D, E, H, P,
                        dims['KS'], k, int(premul), QC, _build.stream_ptr(dev)), name)
    _build.count_launch(LAUNCHES, name)
    return dq, dkv, _split_weight_grads(dw, D, E, H, P, premul)


def _attn_bwd_lib():
    '''The backward kernels' library, its size queries typed.'''
    lib = _build.library('attn_bwd')
    lib.o4d_attn_bwd_weight_floats.restype = ctypes.c_longlong
    lib.o4d_attn_bwd_weight_floats.argtypes = [ctypes.c_int] * 5
    lib.o4d_attn_bwd_plan.restype = None
    lib.o4d_attn_bwd_plan.argtypes = ([ctypes.c_int] * 8 + [ctypes.c_longlong]
                                      + [ctypes.POINTER(ctypes.c_int)]
                                      + [ctypes.POINTER(ctypes.c_longlong)] * 2)
    return lib


def _split_weight_grads(dw, D, E, H, P, premul):
    '''{(name, leaf): view} of the weight-gradient block (its layout:
    csrc/attn_bwd.cu::weight_floats).'''
    sizes = [('attn_mlp_0', 'kernel', (D, H)), ('attn_mlp_2', 'kernel', (H, D)),
             ('pos_mlp_2', 'kernel', (P, D)), ('pos_mlp_0', 'kernel', (3, P)),
             ('attn_mlp_0', 'bias', (H,)), ('attn_mlp_2', 'bias', (D,)),
             ('pos_mlp_2', 'bias', (D,)), ('pos_mlp_0', 'bias', (P,))]
    if not premul:
        sizes += [('to_k', 'kernel', (E, D)), ('to_v', 'kernel', (E, D))]
    grads, off = {}, 0
    for name, leaf, shape in sizes:
        n = math.prod(shape)
        grads[(name, leaf)] = dw[off:off + n].view(shape)
        off += n
    return grads


def attn_bwd(q_pos, q_proj, ki, pos2, kv, params, k, premul, g,
             compute_dtype=torch.float32):
    '''Backward of the attention operator: kernel A (bf16: o4d_attn_bwd_bf16)
    on CUDA, plain version on the CPU.
    :return (d(q_proj), d(kv), {(name, leaf): d(weight)}).'''
    g = g.to(torch.float32).contiguous()
    if q_proj.is_cuda:
        return _attn_bwd_cuda(q_pos, q_proj, ki, pos2, kv, params, k, premul, g,
                              _is_bf16(compute_dtype))
    return attn_bwd_plain(q_pos, q_proj, ki, pos2, kv, params, k, premul, g, compute_dtype)


def _attn_g_bwd_cuda(q_pos, q_proj, g, params, k, go, bf16=False):
    B, N, D = q_proj.shape
    KE, E = g.shape[1], g.shape[-1] - 3
    if tuple(g.shape) != (B, KE, N, E + 3) or not 1 <= k <= min(KE, 32) \
            or tuple(go.shape) != (B, N, D):
        raise ValueError(f'attn_g_bwd: g {tuple(g.shape)}, go {tuple(go.shape)} do '
                         f'not fit B={B}, N={N}, D={D}, k={k}')
    w, b, wk, wv, H, P = _weight_operands(params, D, E, False, bf16=bf16)
    for name, t in (('q_pos', q_pos), ('q_proj', q_proj), ('g', g), ('go', go)):
        _cuda_f32(name, t)
    lib = _attn_bwd_lib()
    n_w = lib.o4d_attn_bwd_weight_floats(D, E, H, P, 0)
    dev = q_proj.device
    # The same chunks as the index route at these sizes (M plays no part).
    QC, ws, _ = _bwd_plan(lib, dev, N, 0, D, E, H, P, k, False)
    dq = torch.empty((B, N, D), dtype=torch.float32, device=dev)
    dw = torch.empty((n_w,), dtype=torch.float32, device=dev)
    dg = torch.empty(g.shape, dtype=torch.float32, device=dev)
    name = 'attn_g_bwd_bf16' if bf16 else 'attn_g_bwd'
    fn = getattr(lib, f'o4d_{name}')
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = [q_pos, q_proj, g, wk, wv] + _weight_ptrs(w, b) + [go, dq, dw, dg, ws]
    with torch.cuda.device(dev), _build.span(name):
        _build.check(fn(*[_build.ptr(t) for t in ptrs], B, N, D, E, H, P, KE, k, QC,
                        _build.stream_ptr(dev)), name)
    _build.count_launch(LAUNCHES, name)
    return dq, dg, _split_weight_grads(dw, D, E, H, P, False)


def attn_g_bwd(q_pos, q_proj, g, params, k, go, compute_dtype=torch.float32):
    '''Backward of the gathered attention operator: its kernel (bf16:
    o4d_attn_g_bwd_bf16) on CUDA, plain version on the CPU.
    :return (d(q_proj), dg, {(name, leaf): d(weight)}).'''
    go = go.to(torch.float32).contiguous()
    if q_proj.is_cuda:
        return _attn_g_bwd_cuda(q_pos, q_proj, g, params, k, go, _is_bf16(compute_dtype))
    return attn_g_bwd_plain(q_pos, q_proj, g, params, k, go, compute_dtype)


class _Attention(torch.autograd.Function):
    '''Forward csrc/attn.cu, backward csrc/attn_bwd.cu (bf16: o4d_attn_bf16,
    o4d_attn_bwd_bf16; plain versions on the CPU). Saves only its inputs.
    Gradients: q_proj, kv and the weights; positions and indices get none.'''

    @staticmethod
    def forward(ctx, q_pos, q_proj, ki, pos2, kv, k, premul, cd, *weights):
        names = _grad_names(premul)
        params = _params(names, weights)
        ctx.save_for_backward(q_pos, q_proj, ki, pos2, kv, *weights)
        ctx.k, ctx.premul, ctx.names, ctx.cd = k, premul, names, cd
        if q_proj.is_cuda:
            return _attn_cuda(q_pos, q_proj, ki, pos2, kv, params, k, premul, _is_bf16(cd))
        return attn_plain(q_pos, q_proj, ki, pos2, kv, params, k, premul, cd)

    @staticmethod
    def backward(ctx, g):
        q_pos, q_proj, ki, pos2, kv, *weights = ctx.saved_tensors
        dq, dkv, dws = attn_bwd(q_pos, q_proj, ki, pos2, kv, _params(ctx.names, weights),
                                ctx.k, ctx.premul, g, ctx.cd)
        return ((None, dq, None, None, dkv, None, None, None)
                + tuple(dws[nl] for nl in ctx.names))


class _AttentionG(torch.autograd.Function):
    '''Forward o4d_attn_g of csrc/attn.cu, backward o4d_attn_g_bwd of
    csrc/attn_bwd.cu (bf16: o4d_attn_g_bf16, o4d_attn_g_bwd_bf16; plain
    versions on the CPU); gradients in q_proj, g and the per-row mode's
    weights.'''

    @staticmethod
    def forward(ctx, q_pos, q_proj, g, k, cd, *weights):
        names = _grad_names(False)
        ctx.save_for_backward(q_pos, q_proj, g, *weights)
        ctx.k, ctx.names, ctx.cd = k, names, cd
        params = _params(names, weights)
        if q_proj.is_cuda:
            return _attn_g_cuda(q_pos, q_proj, g, params, k, _is_bf16(cd))
        return attn_g_plain(q_pos, q_proj, g, params, k, cd)

    @staticmethod
    def backward(ctx, go):
        q_pos, q_proj, g, *weights = ctx.saved_tensors
        dq, dg, dws = attn_g_bwd(q_pos, q_proj, g, _params(ctx.names, weights), ctx.k, go,
                                 ctx.cd)
        return (None, dq, dg, None, None) + tuple(dws[nl] for nl in ctx.names)


def fused_knn_vector_attention(q_proj, q_pos, feats2, pos2, params, k, *,
                               key_mask=None, knn=None, premul=None, gathered=None,
                               compute_dtype=torch.float32):
    '''
    One fused vector cross-attention block, differentiable in q_proj, feats2
    and every weight (positions are constants, as in the JAX module path).
    :param q_proj (B, N, D): projected queries (to_q applied).
    :param q_pos (B, N, 3); feats2 (B, M, E) raw key features; pos2 (B, M, 3).
    :param params: {'to_k', 'to_v', 'pos_mlp_0', 'pos_mlp_2', 'attn_mlp_0',
        'attn_mlp_2'}, each {'kernel' (in, out), ['bias']} torch tensors (the
        JAX package's layout).
    :param knn: optional knn_extract(q_pos, pos2, k' >= k, key_mask) result.
    :param premul (bool or None): project the key set before the gather; None
        applies use_premul.
    :param gathered: optional knn_gather_rows(pos2, feats2, knn, k' >= k)
        result: per-row mode over its rows (premul is not consulted, knn and
        key_mask are not needed); the gradient of the key set flows back
        through the gather.
    :param compute_dtype: torch.float32, or torch.bfloat16 (the bf16 mode:
        o4d_attn_bf16 / o4d_attn_g_bf16, backward o4d_attn_bwd_bf16 /
        o4d_attn_g_bwd_bf16).
    :return (B, N, D) f32.
    '''
    B, N, D = q_proj.shape
    M, E = feats2.shape[1:]
    q_proj = q_proj.to(torch.float32).contiguous()
    if gathered is not None:
        if gathered.shape[0] != B or gathered.shape[1] < k \
                or tuple(gathered.shape[2:]) != (N, E + 3):
            raise ValueError(f'gathered {tuple(gathered.shape)} does not fit B={B}, '
                             f'N={N}, E={E}, k={k}')
        q_pos = q_pos[..., :3].detach().to(torch.float32).contiguous()
        weights = [params[n][leaf].to(torch.float32) for n, leaf in _grad_names(False)]
        return _AttentionG.apply(q_pos, q_proj, gathered.contiguous(), k, compute_dtype,
                                 *weights)
    if knn is None:
        knn = knn_extract(q_pos, pos2, k, key_mask=key_mask)
    ki = knn[0]
    if premul is None:
        premul = use_premul(M, D, E)
    feats2 = feats2.to(torch.float32)
    if premul:
        # Outside the kernel, so autograd chains d(kv) to feats2, Wk and Wv.
        kv = torch.cat([feats2 @ _kernel(params, 'to_k'),
                        feats2 @ _kernel(params, 'to_v')], dim=-1)
    else:
        kv = feats2
    q_pos = q_pos[..., :3].detach().to(torch.float32).contiguous()
    pos2 = pos2[..., :3].detach().to(torch.float32).contiguous()
    weights = [params[n][leaf].to(torch.float32) for n, leaf in _grad_names(premul)]
    return _Attention.apply(q_pos, q_proj, ki.contiguous(), pos2, kv.contiguous(),
                            k, premul, compute_dtype, *weights)
