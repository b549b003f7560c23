'''
Exact k-nearest-neighbour search (port of occlusions4d_tpu/ops/knn.py and the
Hilbert-sorted search of ops/pallas_knn.py::knn_pallas_spatial).

Semantics, shared by the CUDA kernels (csrc/knn.cu) and their plain versions:
  * ranking value d = |k|^2 - 2 q.k in f32, computed as elementwise products
    and sums ((q0 k0 + q1 k1) + q2 k2), never a TF32 or fused product;
  * the K smallest (d, key index) pairs, ascending, ties to the lower key
    index (a stable sort in the plain version); masked keys carry |k|^2 = +inf
    and are never chosen while a valid key remains (filler rows report index 0
    and an infinite distance);
  * returned distances are sqrt(max(d + |q|^2, 0)) (or the squared value).

nn1_direct, the eval engine's ground-truth 1-NN, ranks by another value on
purpose: the direct differences (dx dx + dy dy) + dz dz of the JAX engine's
host op nn1_host, lowest index on ties, which keep the low bits of the
distance at CARLA's coordinate scale (see nn1_direct_plain).

Dispatch: a CUDA tensor always launches a kernel, the brute-force one or the
pruned entry by use_pruned (the H100's crossover); a CPU tensor runs the
plain version. The pruned entry returns exactly the brute-force result (ties
compare on the original key index), so its plain version is the brute-force
one and the switch changes nothing but time.
'''

import ctypes

import torch

from . import _build

__all__ = ['knn', 'knn_pruned', 'knn_rank', 'knn_rank_plain', 'pairwise_sqdist',
           'gather_neighbors', 'hilbert_codes', 'sq_norm', 'nn1_min_dist',
           'nn1_bidirectional', 'nn1_bidir_rank', 'nn1_bidir_plain', 'nn1_direct',
           'nn1_direct_plain', 'use_pruned', 'pruned_prepare_cuda', 'brute_lanes', 'LAUNCHES',
           'PRUNED_MIN_ELEMS', 'PRUNED_MIN_KEYS', 'PRUNED_MAX_KEYS']

LAUNCHES = {'knn_brute': 0, 'knn_pruned': 0, 'nn1_bidir': 0, 'nn1_direct': 0}
# The brute/pruned crossover on an NVIDIA H100 80GB HBM3 at 700 W (the sweep
# in PERF.md; chip_smoke.py prints it as its knn_crossover line): the brute
# kernel's time grows with N * M * K, the pruned entry costs about 0.1 ms of
# preparation and launches plus a search that pays only once the keys span
# enough 256-key blocks to skip some (K 1: brute up to 3000^2, pruned from
# 4779^2; K 16: pruned from 1024^2; 3 x 531 x 1593 at K 12: brute 0.18 ms,
# pruned 0.22; 531^2: brute).
PRUNED_MIN_ELEMS = 2 ** 24   # N * M * K
PRUNED_MIN_KEYS = 1024
# The widest key set the pruned kernel takes: its per-block gap and order
# arrays (12 B per 256-key block) fill the shared memory left beside 20 KB
# (csrc/knn.cu o4d_knn_pruned_max_keys, the same formula). Wider searches
# take the brute kernel, which has no such limit and gives the same bits.
PRUNED_MAX_KEYS = (232448 - 20 * 1024) // 12 * 256
_MAX_K = 32
_PLAIN_CHUNK = 2 ** 25  # distance entries per plain-version slab.
_FLT_MAX = 3.4028234663852886e38


def sq_norm(x):
    '''|x|^2 over the last (xyz) axis as ((x0 x0 + x1 x1) + x2 x2).'''
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def pairwise_sqdist(query, keys):
    '''(..., N, M) squared distances |q|^2 + |k|^2 - 2 q.k, clamped at 0.'''
    q2 = sq_norm(query)[..., :, None]
    k2 = sq_norm(keys)[..., None, :]
    qk = (query[..., :, None, 0] * keys[..., None, :, 0]
          + query[..., :, None, 1] * keys[..., None, :, 1]
          + query[..., :, None, 2] * keys[..., None, :, 2])
    return torch.clamp(q2 + k2 - 2.0 * qk, min=0.0)


def gather_neighbors(values, idx):
    '''values (B, M, D), idx (B, N, K) -> (B, N, K, D).'''
    B, N, K = idx.shape
    flat = idx.reshape(B, N * K).long()
    out = torch.gather(values, 1, flat[..., None].expand(B, N * K, values.shape[-1]))
    return out.reshape(B, N, K, values.shape[-1])


def knn_rank_plain(q, keys, kn, k):
    '''Plain version of the kNN kernels.
    :param q (B, N, 3) f32; keys (B, M, 3) f32; kn (B, M) f32 (|k|^2, +inf
        masked).
    :return (d (B, N, k) f32 ranking values, idx (B, N, k) int32).'''
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
        vals, order = torch.sort(d, dim=-1, stable=True)
        vals, order = vals[..., :k], order[..., :k]
        ds.append(vals)
        ids.append(torch.where(torch.isinf(vals), torch.zeros_like(order), order))
    return torch.cat(ds, 1), torch.cat(ids, 1).to(torch.int32)


def _check_cuda(name, t, shape, dtype):
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous CUDA {dtype} tensor, got '
                         f'{t.device} {t.dtype} contiguous={t.is_contiguous()}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}')


def brute_lanes(B, N):
    '''Lanes per query of the brute kernel (csrc/knn.cu knn_brute_kernel)
    for B * N queries: a warp per query while 16 lanes would leave the H100
    under two waves of 1024 threads per SM (fewer than 16896 queries: the
    encoder's searches), else 16, the two counts the kernel takes. Measured
    on an H100 (PERF.md, chip_smoke.py entry_ms_by_lanes): 16 lanes beat 32
    at the decoder chunks and train frames; 32 wins at the encoder's
    searches.'''
    return 32 if B * N * 16 < 2 * 132 * 1024 else 16


def _brute_cuda(q, keys, kn, k):
    B, N, _ = q.shape
    M = keys.shape[1]
    keys4 = torch.cat([keys, kn[..., None]], dim=-1).contiguous()
    _check_cuda('q', q, (B, N, 3), torch.float32)
    _check_cuda('keys4', keys4, (B, M, 4), torch.float32)
    out_d = torch.empty((B, N, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((B, N, k), dtype=torch.int32, device=q.device)
    lib = _build.library('knn')
    fn = lib.o4d_knn_brute
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        _build.check(fn(_build.ptr(q), _build.ptr(keys4), _build.ptr(out_d),
                        _build.ptr(out_i), B, N, M, k, brute_lanes(B, N),
                        _build.stream_ptr(q.device)), 'knn_brute')
    _build.count_launch(LAUNCHES, 'knn_brute')
    return out_d, out_i


def knn_rank(q, keys, kn, k):
    '''Brute-force entry: kernel on CUDA, plain version on the CPU.'''
    if not 1 <= k <= min(_MAX_K, keys.shape[1]):
        raise ValueError(f'k={k} must lie in [1, min(32, M={keys.shape[1]})]')
    if q.is_cuda:
        return _brute_cuda(q, keys, kn, k)
    return knn_rank_plain(q, keys, kn, k)


def _part1by2(x):
    x = x & 0x3ff
    x = (x | (x << 16)) & 0x030000ff
    x = (x | (x << 8)) & 0x0300f00f
    x = (x | (x << 4)) & 0x030c30c3
    x = (x | (x << 2)) & 0x09249249
    return x


def hilbert_codes(pts, lo, hi, bits=10):
    '''30-bit Hilbert codes of (B, N, 3) points within per-example bounds
    (Skilling's transpose form; the same integers as
    occlusions4d_tpu/ops/pallas_knn.py::_hilbert_codes).'''
    top = 2.0 ** bits - 1.0
    scale = torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp((pts - lo) / scale * top, 0.0, top).to(torch.int32)
    X = [q[..., 0], q[..., 1], q[..., 2]]
    Q = 1 << (bits - 1)
    while Q > 1:
        P = Q - 1
        for i in range(3):
            hit = (X[i] & Q) > 0
            t = (X[0] ^ X[i]) & P
            new_x0 = torch.where(hit, X[0] ^ P, X[0] ^ t)
            if i != 0:
                X[i] = torch.where(hit, X[i], X[i] ^ t)
            X[0] = new_x0
        Q >>= 1
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = torch.zeros_like(X[0])
    Q = 1 << (bits - 1)
    while Q > 1:
        t = torch.where((X[2] & Q) > 0, t ^ (Q - 1), t)
        Q >>= 1
    X = [x ^ t for x in X]
    return _part1by2(X[2]) | (_part1by2(X[1]) << 1) | (_part1by2(X[0]) << 2)


def _pad_rows(x, n):
    '''Pad (B, R, C) to n rows by repeating the last row.'''
    if x.shape[1] == n:
        return x
    return torch.cat([x, x[:, -1:].expand(x.shape[0], n - x.shape[1], x.shape[2])], 1)


def _boxes(pts, size):
    '''(B, R, 3) with R a multiple of size -> (B, R / size, 6) (lo, hi).'''
    B, R, _ = pts.shape
    p = pts.reshape(B, R // size, size, 3)
    return torch.cat([p.amin(2), p.amax(2)], -1).contiguous()


def pruned_inputs(q, keys, kn, same, tile, block):
    '''Plain version of the pruned search's preparation (csrc/knn.cu
    knn_bbox_kernel, knn_codes_kernel, the sorts and knn_arrange_kernel), the
    operands of knn_pruned_kernel: both sets in curve order (the keys'
    Hilbert curve within the keys' box), padded (last row repeated; padded
    keys get |k|^2 = +inf), as rows (x, y, z, |p|^2); the sorted keys'
    original indices (0 at padding) and the queries' (-1 at padding); per
    block key and per tile query boxes; the sorted codes of both sets; and
    the bbox test's rounding slack, 1e-5 (largest finite |k|^2 + largest
    |q|^2), as a (1,) tensor.'''
    B, N, _ = q.shape
    M = keys.shape[1]
    lo = keys.amin(1, keepdim=True)
    hi = keys.amax(1, keepdim=True)
    kcode, perm_k = torch.sort(hilbert_codes(keys, lo, hi), dim=-1, stable=True)
    if same and N == M:
        qcode, perm_q = kcode, perm_k
    else:
        qcode, perm_q = torch.sort(hilbert_codes(q, lo, hi), dim=-1, stable=True)
    N_pad = -(-N // tile) * tile
    M_pad = -(-M // block) * block
    keys_s = torch.gather(keys, 1, perm_k[..., None].expand(B, M, 3))
    q_s = torch.gather(q, 1, perm_q[..., None].expand(B, N, 3))
    k_p = _pad_rows(keys_s, M_pad)
    q_p = _pad_rows(q_s, N_pad)
    kn_p = torch.cat([torch.gather(kn, 1, perm_k),
                      kn.new_full((B, M_pad - M), float('inf'))], 1)
    qn = sq_norm(q_p)
    korig = torch.cat([perm_k, perm_k.new_zeros((B, M_pad - M))], 1).to(torch.int32)
    qorig = torch.cat([perm_q, perm_q.new_full((B, N_pad - N), -1)], 1).to(torch.int32)
    # Rounding slack of the bbox test: the expanded distance |k|^2 - 2 q.k +
    # |q|^2 carries an absolute error of a few ulps of |k|^2 + |q|^2, so a key
    # block is skipped only when its gap^2 exceeds the bound by far more.
    kn_fin = torch.where(torch.isfinite(kn_p), kn_p, torch.zeros_like(kn_p))
    slack = ((kn_fin.max() + qn.max()) * 1e-5).reshape(1)
    return dict(q4=torch.cat([q_p, qn[..., None]], -1), qorig=qorig,
                keys4=torch.cat([k_p, kn_p[..., None]], -1), korig=korig,
                kbox=_boxes(k_p, block), tbox=_boxes(q_p, tile), kcode=kcode,
                qcode=qcode, slack=slack)


def _pruned_lib():
    lib = _build.library('knn')
    for f in (lib.o4d_knn_prune_tile, lib.o4d_knn_prune_block, lib.o4d_knn_pruned_max_keys):
        f.argtypes, f.restype = [], ctypes.c_int
    lib.o4d_knn_pruned_ws_bytes.argtypes = [ctypes.c_int] * 3
    lib.o4d_knn_pruned_ws_bytes.restype = ctypes.c_longlong
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.o4d_knn_prune_codes.argtypes = [vp] * 5 + [ci] * 3 + [vp]
    lib.o4d_knn_pruned_arrange.argtypes = [vp] * 6 + [ci] * 3 + [vp]
    lib.o4d_knn_pruned.argtypes = [vp] * 6 + [ci] * 4 + [vp]
    for f in (lib.o4d_knn_prune_codes, lib.o4d_knn_pruned_arrange, lib.o4d_knn_pruned):
        f.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else _build.ptr(t)


def pruned_prepare_cuda(q, keys, kn, same):
    '''The pruned search's preparation on the card (the kernels'
    counterpart of pruned_inputs): the keys' box, the Hilbert codes, their
    stable sorts and the arrangement. :return (workspace, sorted key codes,
    sorted query codes).'''
    B, N, _ = q.shape
    M = keys.shape[1]
    lib = _pruned_lib()
    if M > lib.o4d_knn_pruned_max_keys():
        raise NotImplementedError(f'the pruned kNN kernel takes at most '
                                  f'{lib.o4d_knn_pruned_max_keys()} keys; got M={M}')
    self_search = same and N == M
    _check_cuda('q', q, (B, N, 3), torch.float32)
    _check_cuda('keys', keys, (B, M, 3), torch.float32)
    _check_cuda('kn', kn, (B, M), torch.float32)
    dev = q.device
    lohi = torch.empty((B, 6), dtype=torch.float32, device=dev)
    ck = torch.empty((B, M), dtype=torch.int32, device=dev)
    cq = None if self_search else torch.empty((B, N), dtype=torch.int32, device=dev)
    qq = keys if self_search else q
    with torch.cuda.device(dev):
        stream = _build.stream_ptr(dev)
        _build.check(lib.o4d_knn_prune_codes(_ptr(keys), _ptr(None if self_search else q),
                                             _ptr(lohi), _ptr(ck), _ptr(cq), B, N, M, stream),
                     'knn_pruned')
        sk, pk = torch.sort(ck, dim=-1, stable=True)
        sq, pq = (sk, pk) if self_search else torch.sort(cq, dim=-1, stable=True)
        ws = torch.empty((lib.o4d_knn_pruned_ws_bytes(B, N, M),), dtype=torch.uint8,
                         device=dev)
        _build.check(lib.o4d_knn_pruned_arrange(_ptr(keys), _ptr(kn), _ptr(qq), _ptr(pk),
                                                _ptr(pq), _ptr(ws), B, N, M, stream),
                     'knn_pruned')
    return ws, sk, sq


def _pruned_cuda(q, keys, kn, k, same, visited=None):
    '''The pruned search on the card: pruned_prepare_cuda, then the pruned
    kernel. visited: None, or a (1,) int32 CUDA tensor the number of
    (query tile, key block) pairs processed is added to.'''
    B, N, _ = q.shape
    M = keys.shape[1]
    ws, sk, sq = pruned_prepare_cuda(q, keys, kn, same)
    out_d = torch.empty((B, N, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((B, N, k), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        _build.check(_pruned_lib().o4d_knn_pruned(
            _ptr(sk), _ptr(sq), _ptr(ws), _ptr(out_d), _ptr(out_i), _ptr(visited), B, N, M, k,
            _build.stream_ptr(q.device)), 'knn_pruned')
    _build.count_launch(LAUNCHES, 'knn_pruned')
    return out_d, out_i


def _prepare(query, keys, key_mask):
    q = query[..., :3].to(torch.float32)
    kk = keys[..., :3].to(torch.float32)
    batch_shape = q.shape[:-2]
    N, M = q.shape[-2], kk.shape[-2]
    q = q.reshape(-1, N, 3).contiguous()
    kk = kk.reshape(-1, M, 3).contiguous()
    kn = sq_norm(kk)
    if key_mask is not None:
        km = key_mask.reshape(-1, M).to(torch.bool)
        kn = torch.where(km, kn, torch.full_like(kn, float('inf')))
    return q, kk, kn.contiguous(), batch_shape


def _finish(q, d, idx, batch_shape, euclidean):
    d2 = torch.clamp(d + sq_norm(q)[..., None], min=0.0)
    dist = torch.sqrt(d2) if euclidean else d2
    N, k = d.shape[-2:]
    return dist.reshape(batch_shape + (N, k)), idx.reshape(batch_shape + (N, k))


def knn_pruned(query, keys, k, *, key_mask=None, euclidean=True, same=None):
    '''Exact kNN through the Hilbert-sorted, bbox-pruned kernel (CUDA); the
    plain version is the brute-force search, whose result it equals.'''
    if same is None:
        same = query is keys
    q, kk, kn, batch_shape = _prepare(query, keys, key_mask)
    if not 1 <= k <= min(_MAX_K, kk.shape[1]):
        raise ValueError(f'k={k} must lie in [1, min(32, M={kk.shape[1]})]')
    if q.is_cuda:
        d, idx = _pruned_cuda(q, kk, kn, k, same)
    else:
        d, idx = knn_rank_plain(q, kk, kn, k)
    return _finish(q, d, idx, batch_shape, euclidean)


def use_pruned(N, M, k):
    '''Whether knn sends an (N queries, M keys, k) search to the pruned
    entry: the H100's crossover (PRUNED_MIN_ELEMS, PRUNED_MIN_KEYS), within
    the pruned kernel's key limit (PRUNED_MAX_KEYS).'''
    return (N * M * k >= PRUNED_MIN_ELEMS
            and PRUNED_MIN_KEYS <= M <= PRUNED_MAX_KEYS)


def knn(query, keys, k, *, key_mask=None, euclidean=True, pruned=None):
    '''
    For each query point, the k nearest key points by 3D Euclidean distance.
    :param query (..., N, C>=3); keys (..., M, C>=3): only xyz is used.
    :param key_mask (..., M) bool or None: invalid keys are never returned.
    :param pruned (bool or None): force the pruned entry on/off; None picks
        it by use_pruned.
    :return (dists (..., N, k), idx (..., N, k) int32), ascending.
    '''
    same = query is keys
    N, M = query.shape[-2], keys.shape[-2]
    if pruned is None:
        pruned = use_pruned(N, M, k)
    if pruned:
        return knn_pruned(query, keys, k, key_mask=key_mask, euclidean=euclidean,
                          same=same)
    q, kk, kn, batch_shape = _prepare(query, keys, key_mask)
    d, idx = knn_rank(q, kk, kn, k)
    return _finish(q, d, idx, batch_shape, euclidean)


def nn1_min_dist(query, keys, *, key_mask=None):
    '''Euclidean distance from each query to its nearest valid key: the k = 1
    case of knn (brute-force or pruned kernel by size). :return (..., N).'''
    d, _ = knn(query, keys, 1, key_mask=key_mask)
    return d[..., 0]


def nn1_bidir_plain(a, an, b, bn):
    '''Plain version of the bidirectional 1-NN kernel.
    :param a (B, N, 3), b (B, M, 3) f32; an (B, N), bn (B, M) squared norms
        (+inf at masked points).
    :return (out_a (B, N), out_b (B, M)): min_j (bn_j - 2 a_i.b_j) and
        min_i (an_i - 2 a_i.b_j).'''
    B, N, _ = a.shape
    M = b.shape[1]
    rows = max(1, _PLAIN_CHUNK // max(M, 1))
    outs_a = []
    out_b = torch.full((B, M), float('inf'), dtype=torch.float32, device=a.device)
    for r0 in range(0, N, rows):
        ac = a[:, r0:r0 + rows]
        dot = (ac[:, :, None, 0] * b[:, None, :, 0] + ac[:, :, None, 1] * b[:, None, :, 1]
               + ac[:, :, None, 2] * b[:, None, :, 2])
        t = 2.0 * dot
        outs_a.append((bn[:, None, :] - t).amin(-1))
        out_b = torch.minimum(out_b, (an[:, r0:r0 + rows, None] - t).amin(1))
    return torch.cat(outs_a, 1), out_b


def _nn1_bidir_cuda(a, an, b, bn):
    B, N, _ = a.shape
    M = b.shape[1]
    a4 = torch.cat([a, an[..., None]], -1).contiguous()
    b4 = torch.cat([b, bn[..., None]], -1).contiguous()
    _check_cuda('a4', a4, (B, N, 4), torch.float32)
    _check_cuda('b4', b4, (B, M, 4), torch.float32)
    out_a = torch.full((B, N), float('inf'), dtype=torch.float32, device=a.device)
    out_b = torch.full((B, M), float('inf'), dtype=torch.float32, device=a.device)
    fn = _build.library('knn').o4d_nn1_bidir
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        _build.check(fn(_build.ptr(a4), _build.ptr(b4), _build.ptr(out_a),
                        _build.ptr(out_b), B, N, M, _build.stream_ptr(a.device)),
                     'nn1_bidir')
    _build.count_launch(LAUNCHES, 'nn1_bidir')
    return out_a, out_b


def nn1_bidir_rank(a, an, b, bn):
    '''Bidirectional 1-NN ranking values: kernel on CUDA, plain version on
    the CPU (same arguments and result as nn1_bidir_plain).'''
    if a.is_cuda:
        return _nn1_bidir_cuda(a, an, b, bn)
    return nn1_bidir_plain(a, an, b, bn)


def nn1_bidirectional(a, b, *, a_mask=None, b_mask=None):
    '''
    Both directions of exact 1-NN between two point sets in one pass:
    dist_a[i] = min over valid b_j of |a_i - b_j|, dist_b[j] = min over valid
    a_i of |a_i - b_j| (port of occlusions4d_tpu/ops/knn.py::nn1_bidirectional).
    :param a (..., N, C>=3); b (..., M, C>=3): only xyz is used.
    :param a_mask (..., N) / b_mask (..., M) bool or None: a masked point never
        acts as the nearest neighbour of the other set.
    :return (dist_a (..., N), dist_b (..., M)) f32.
    '''
    a3 = a[..., :3].to(torch.float32)
    b3 = b[..., :3].to(torch.float32)
    batch_shape = a3.shape[:-2]
    N, M = a3.shape[-2], b3.shape[-2]
    a3 = a3.reshape(-1, N, 3).contiguous()
    b3 = b3.reshape(-1, M, 3).contiguous()
    an_true, bn_true = sq_norm(a3), sq_norm(b3)
    an, bn = an_true, bn_true
    if a_mask is not None:
        an = torch.where(a_mask.reshape(-1, N), an, torch.full_like(an, float('inf')))
    if b_mask is not None:
        bn = torch.where(b_mask.reshape(-1, M), bn, torch.full_like(bn, float('inf')))
    out_a, out_b = nn1_bidir_rank(a3, an, b3, bn)
    d_a = torch.sqrt(torch.clamp(out_a + an_true, min=0.0))
    d_b = torch.sqrt(torch.clamp(out_b + bn_true, min=0.0))
    return d_a.reshape(batch_shape + (N,)), d_b.reshape(batch_shape + (M,))


def nn1_direct_plain(query, keys):
    '''Plain version of the direct-difference 1-NN kernel, the arithmetic of
    occlusions4d_tpu/native/host_ops.cpp::o4d_nn1: per pair d2 = (dx dx + dy dy)
    + dz dz with dx = key - query (each product and sum its own rounding), the
    first key of the smallest d2 below FLT_MAX (index 0 when none is), and
    sqrt at the end. Chunked over queries (2^23 pairs per slab).
    :param query (N, 3) f32; keys (M, 3) f32.
    :return (dist (N,) f32, idx (N,) int32).'''
    N, M = query.shape[0], keys.shape[0]
    rows = max(1, 2 ** 23 // max(M, 1))
    ds, ids = [], []
    for r0 in range(0, N, rows):
        qc = query[r0:r0 + rows]
        dx = keys[None, :, 0] - qc[:, None, 0]
        dy = keys[None, :, 1] - qc[:, None, 1]
        dz = keys[None, :, 2] - qc[:, None, 2]
        d = (dx * dx + dy * dy) + dz * dz
        best, idx = torch.min(d, dim=1)     # the first index of the minimum.
        found = best < _FLT_MAX
        ds.append(torch.where(found, best, torch.full_like(best, _FLT_MAX)))
        ids.append(torch.where(found, idx, torch.zeros_like(idx)))
    # A correctly rounded f32 root (as sqrtf): through f64, exact for f32.
    dist = torch.sqrt(torch.cat(ds).to(torch.float64)).to(torch.float32)
    return dist, torch.cat(ids).to(torch.int32)


def _nn1_direct_cuda(q, keys):
    N, M = q.shape[0], keys.shape[0]
    keys4 = torch.cat([keys, keys.new_zeros((M, 1))], -1).contiguous()
    _check_cuda('query', q, (N, 3), torch.float32)
    _check_cuda('keys4', keys4, (M, 4), torch.float32)
    out_d = torch.empty((N,), dtype=torch.float32, device=q.device)
    out_i = torch.empty((N,), dtype=torch.int32, device=q.device)
    fn = _build.library('knn').o4d_nn1_direct
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        _build.check(fn(_build.ptr(q), _build.ptr(keys4), _build.ptr(out_d),
                        _build.ptr(out_i), N, M, _build.stream_ptr(q.device)),
                     'nn1_direct')
    _build.count_launch(LAUNCHES, 'nn1_direct')
    return out_d, out_i


def nn1_direct(query, keys):
    '''
    Exact Euclidean 1-NN of every query row among the key rows by direct
    differences, as the JAX engine's nn1_host computes the eval labels: the
    kernel on CUDA, the plain version on the CPU.
    :param query (N, C>=3); keys (M>=1, C>=3): only xyz is used.
    :return (dist (N,) f32, idx (N,) int32).
    '''
    q = query[:, :3].to(torch.float32).contiguous()
    k = keys[:, :3].to(torch.float32).contiguous()
    if k.shape[0] < 1:
        raise ValueError('nn1_direct needs at least one key')
    if q.is_cuda:
        return _nn1_direct_cuda(q, k)
    return nn1_direct_plain(q, k)
