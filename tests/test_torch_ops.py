'''
The PyTorch port's kernel modules (occlusions4d_torch.ops) held against the JAX
package on the CPU. The port runs its kernels' plain versions here (CPU
tensors); the JAX side runs as its own tests run it: the XLA path where
knn/fps_batched pick it off-TPU, Pallas kernels in interpret mode. Inputs are
made with numpy from a seed and handed to both.

Tolerances: kNN and FPS indices are exact (the port reproduces the selection
arithmetic and the tie rule); float outputs follow the JAX tests' f32 CPU
tolerance atol=3e-5, rtol=1e-4 (different summation order and fused
multiply-adds between XLA and PyTorch's CPU kernels).
'''

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# Six test workers share eight cores: keep PyTorch's CPU pool small.
torch.set_num_threads(2)

from occlusions4d_tpu.ops.knn import knn as j_knn
from occlusions4d_tpu.ops.fps import fps_batched as j_fps_batched
from occlusions4d_tpu.ops.interpolate import knn_interpolate as j_knn_interpolate
from occlusions4d_tpu.ops.pallas_attention import (
    fused_knn_interp as j_fused_knn_interp,
    fused_knn_vector_attention as j_fused_attn,
    knn_extract as j_knn_extract)
from occlusions4d_tpu.ops.pallas_fps import fps_pallas_batched as j_fps_pallas
from occlusions4d_tpu.ops.pallas_knn import (_hilbert_codes, knn_pallas,
                                             knn_pallas_spatial)
from occlusions4d_torch.ops.fps import fps_batched as t_fps_batched

# The packages re-export functions named like their modules: load by path.
t_knn = importlib.import_module('occlusions4d_torch.ops.knn')
t_attn = importlib.import_module('occlusions4d_torch.ops.attention')

ATOL, RTOL = 3e-5, 1e-4


@pytest.fixture
def rng():
    return np.random.RandomState(23)


def _t(a):
    return torch.tensor(np.asarray(a))


def _knn_both(q, k, K, mask=None):
    jd, ji = j_knn(jnp.asarray(q), jnp.asarray(k), K,
                          key_mask=None if mask is None else jnp.asarray(mask))
    td, ti = t_knn.knn(_t(q), _t(k), K, key_mask=None if mask is None else _t(mask))
    return (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy())


@pytest.mark.parametrize('masked', [False, True])
def test_knn_matches_jax_xla(rng, masked):
    q = rng.rand(2, 150, 3).astype(np.float32) * 2 - 1
    k = rng.rand(2, 300, 3).astype(np.float32) * 2 - 1
    mask = (rng.rand(2, 300) > 0.3) if masked else None
    (jd, ji), (td, ti) = _knn_both(q, k, 8, mask)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, atol=ATOL, rtol=RTOL)
    if masked:
        assert all(mask[b][ti[b]].all() for b in range(2))


def test_knn_matches_pallas_kernels(rng):
    q = rng.rand(1, 200, 3).astype(np.float32) * 4 - 2
    k = rng.rand(1, 260, 3).astype(np.float32) * 4 - 2
    mask = rng.rand(1, 260) > 0.2
    for K in (1, 12, 16):
        jd, ji = knn_pallas(jnp.asarray(q), jnp.asarray(k), K,
                            key_mask=jnp.asarray(mask), euclidean=False)
        td, ti = t_knn.knn(_t(q), _t(k), K, key_mask=_t(mask), euclidean=False,
                           pruned=False)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL, rtol=RTOL)


def test_knn_pruned_matches_pallas_spatial(rng):
    pts = rng.rand(1, 300, 3).astype(np.float32) * 6 - 3
    jd, ji = knn_pallas_spatial(jnp.asarray(pts), jnp.asarray(pts), 16,
                                same=True, block_k=128)
    td, ti = t_knn.knn_pruned(_t(pts), _t(pts), 16, same=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL, rtol=RTOL)


def test_knn_extract_matches_pallas(rng):
    q = rng.rand(1, 140, 3).astype(np.float32) * 2 - 1
    k = rng.rand(1, 70, 3).astype(np.float32) * 2 - 1
    mask = rng.rand(1, 70) > 0.25
    ji, jd = j_knn_extract(jnp.asarray(q), jnp.asarray(k), 14, key_mask=jnp.asarray(mask))
    ti, tdd = t_attn.knn_extract(_t(q), _t(k), 14, key_mask=_t(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji)[:, :140, :14])
    np.testing.assert_allclose(tdd.numpy(), np.asarray(jd)[:, :140, :14],
                               atol=ATOL, rtol=RTOL)


def test_knn_exact_ties_go_to_lower_index(rng):
    '''Integer coordinates make every distance exact: duplicate keys and
    equidistant keys tie, and all paths must pick the lower key index.'''
    k = rng.randint(0, 3, size=(1, 90, 3)).astype(np.float32)
    k[0, 50:60] = k[0, 10:20]                                 # exact duplicates.
    q = rng.randint(0, 3, size=(1, 40, 3)).astype(np.float32)
    (jd, ji), (td, ti) = _knn_both(q, k, 12)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    _, jpi = knn_pallas(jnp.asarray(q), jnp.asarray(k), 12)
    np.testing.assert_array_equal(ti, np.asarray(jpi))
    # Within a run of equal distances indices ascend.
    d2 = ((q[0, :, None] - k[0, ti[0]]) ** 2).sum(-1)
    same = d2[:, 1:] == d2[:, :-1]
    assert same.any() and (ti[0][:, 1:][same] > ti[0][:, :-1][same]).all()
    # The pruned entry compares ties on the ORIGINAL key index: same result.
    _, tpi = t_knn.knn_pruned(_t(q), _t(k), 12)
    np.testing.assert_array_equal(tpi.numpy(), ti)


def _top_k(d, i, k):
    '''Lexicographic (d, index) top k along the last axis: sort by index,
    then stably by d.'''
    o = torch.argsort(i, dim=-1, stable=True)
    d, i = torch.gather(d, -1, o), torch.gather(i, -1, o)
    o = torch.argsort(d, dim=-1, stable=True)[..., :k]
    return torch.gather(d, -1, o), torch.gather(i, -1, o)


def _emulate_pruned_kernel(ops, k, tile, block, lanes=8):
    '''Python model of csrc/knn.cu::knn_pruned_kernel over pruned_inputs():
    per tile, the seed block (a binary search of the tile's middle query code
    in the sorted key codes), the key blocks ranked by (gap^2, distance from
    the seed, index) and visited while gap^2 <= bound + slack, the bound
    read one block late (one barrier per block) and a block chosen with an
    older bound tested again before it is processed; `lanes` lanes per
    query, key c of a block on lane c mod lanes, each lane's exact top k,
    the bound a query's smallest lane K-th plus |q|^2, merged at the end;
    rows written at their original query index. :return (d, idx, the share
    of (tile, key block) pairs processed).'''
    q4, qorig, keys4, korig = ops['q4'][0], ops['qorig'][0], ops['keys4'][0], ops['korig'][0]
    kbox, tbox, slack = ops['kbox'][0], ops['tbox'][0], ops['slack'][0]
    kcode, qcode = ops['kcode'][0], ops['qcode'][0]
    N = qcode.shape[0]
    nt, nb = q4.shape[0] // tile, keys4.shape[0] // block
    out_d = torch.empty(N, k)
    out_i = torch.empty(N, k, dtype=torch.int32)
    processed = 0
    for t in range(nt):
        qt = q4[t * tile:(t + 1) * tile]
        code = qcode[min(t * tile + tile // 2, N - 1)]
        seed = min(int(torch.searchsorted(kcode, code)) // block, nb - 1)
        g = torch.clamp(torch.maximum(kbox[:, :3] - tbox[t, 3:], tbox[t, :3] - kbox[:, 3:]),
                        min=0.0)
        gap = (g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1]) + g[:, 2] * g[:, 2]
        order = sorted(range(nb), key=lambda j: (float(gap[j]), abs(j - seed), j))
        acc_d = torch.full((tile, lanes, k), float('inf'))
        acc_i = torch.zeros((tile, lanes, k), dtype=torch.int64)

        def process(j):
            kb, ko = keys4[j * block:(j + 1) * block], korig[j * block:(j + 1) * block].long()
            dot = (qt[:, None, 0] * kb[None, :, 0] + qt[:, None, 1] * kb[None, :, 1]) \
                + qt[:, None, 2] * kb[None, :, 2]
            d = kb[None, :, 3] - 2.0 * dot
            for ln in range(lanes):
                acc_d[:, ln], acc_i[:, ln] = _top_k(
                    torch.cat([acc_d[:, ln], d[:, ln::lanes]], 1),
                    torch.cat([acc_i[:, ln], ko[ln::lanes][None].expand(tile, -1)], 1), k)

        def bound():
            return (acc_d[:, :, -1].amin(1) + qt[:, 3]).max()

        cur, pos, bnd, it = order[0], 1, torch.tensor(float('inf')), 0
        while True:
            if it > 0:
                bnd = bound_after
            proc = it == 0 or bool(gap[cur] <= bnd + slack)
            nxt = order[pos] if pos < nb and bool(gap[order[pos]] <= bnd + slack) else None
            pos += nxt is not None
            if proc:
                process(cur)
                processed += 1
            bound_after = bound()
            if nxt is None:
                break
            cur, it = nxt, it + 1
        d, i = _top_k(acc_d.reshape(tile, -1), acc_i.reshape(tile, -1), k)
        live = qorig[t * tile:(t + 1) * tile] >= 0
        rows = qorig[t * tile:(t + 1) * tile][live].long()
        out_d[rows], out_i[rows] = d[live], i[live].to(torch.int32)
    return out_d[None], out_i[None], processed / (nt * nb)


def _pruned_case(rng, case):
    '''(queries, keys, key mask, K) of one emulated-kernel case.'''
    if case == 'clustered_self':
        centers = rng.rand(6, 3).astype(np.float32) * 20 - 10
        pts = (centers[rng.randint(0, 6, 500)]
               + rng.randn(500, 3).astype(np.float32) * 0.5)[None].astype(np.float32)
        return pts[:, :300], pts, None, 10
    if case == 'grid_ties':
        k = rng.randint(0, 4, size=(1, 410, 3)).astype(np.float32)
        q = rng.randint(0, 4, size=(1, 123, 3)).astype(np.float32)
        return q, k, None, 7
    k = rng.rand(1, 700, 3).astype(np.float32) * 10 - 5
    u = rng.randn(1, 250, 3)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    q = np.take_along_axis(k, rng.randint(0, 700, (1, 250))[..., None], 1) + u * 0.4
    if case.startswith('far'):
        q = q + np.sign(q) * rng.rand(1, 250, 1) * 30
    return q.astype(np.float32), k, rng.rand(1, 700) > 0.2, 1 if case.endswith('k1') else 16


@pytest.mark.parametrize('case', ['clustered_self', 'cross_masked_k1', 'far_queries_k1',
                                  'far_queries_k16', 'grid_ties'])
def test_knn_pruned_inputs_and_emulated_kernel_equal_brute_force(rng, case):
    '''The pruned path's preparation (Hilbert sort, padding, boxes, slack)
    with a model of its kernel (seed search, gap-ordered visits, one bound
    refresh per processed block, lanes merged at the end) reproduces the
    brute-force search exactly: clustered data (where it processes fewer
    than half the key blocks), the sampler's cross search at K 1 with masked
    keys, queries far outside the keys' box, integer-grid duplicates and
    ties; N and M off the tile (16) and block (32) sizes.'''
    q, k, mask, K = _pruned_case(rng, case)
    q_t, k_t = _t(q), _t(k)
    qq, kk, kn, _ = t_knn._prepare(q_t, k_t, None if mask is None else _t(mask))
    if case == 'clustered_self':
        qq = kk[:, :300]
    ops = t_knn.pruned_inputs(qq, kk, kn, False, 16, 32)
    d, i, frac = _emulate_pruned_kernel(ops, K, 16, 32)
    bd, bi = t_knn.knn_rank_plain(qq, kk, kn, K)
    np.testing.assert_array_equal(i.numpy(), bi.numpy())
    np.testing.assert_array_equal(d.numpy(), bd.numpy())
    if case == 'clustered_self':
        assert frac < 0.5, frac


def test_knn_pruned_self_search_preparation(rng):
    '''A self search sorts once: both sets share the keys' order and codes,
    the padded query rows repeat the last one with original index -1, and
    the padded keys carry +inf at index 0.'''
    pts = _t(rng.rand(1, 70, 3).astype(np.float32))
    q, kk, kn, _ = t_knn._prepare(pts, pts, None)
    ops = t_knn.pruned_inputs(kk, kk, kn, True, 16, 32)
    assert torch.equal(ops['qcode'], ops['kcode'])
    assert torch.equal(ops['q4'][0, :70, :3], ops['keys4'][0, :70, :3])
    assert (ops['qorig'][0, 70:] == -1).all() and torch.equal(ops['q4'][0, 70:],
                                                               ops['q4'][0, 69:70].expand(10, 4))
    assert torch.isinf(ops['keys4'][0, 70:, 3]).all() and (ops['korig'][0, 70:] == 0).all()
    assert torch.equal(ops['q4'][0, :, 3], t_knn.sq_norm(ops['q4'][0, :, :3]))


@pytest.mark.parametrize('M, want', [(1023, False), (1024, True), (4_521_984, True),
                                     (4_521_985, False)])
def test_use_pruned_keeps_to_the_pruned_kernels_key_range(M, want):
    '''knn sends a large search to the pruned entry only from
    PRUNED_MIN_KEYS keys up to the pruned kernel's limit PRUNED_MAX_KEYS
    (17664 blocks of 256 keys); wider key sets take the brute kernel.'''
    assert t_knn.PRUNED_MAX_KEYS == 4_521_984
    assert t_knn.use_pruned(4096, M, 16) is want


def test_pairwise_sqdist_and_knn_interpolate_match_jax(rng):
    from occlusions4d_tpu.ops.knn import pairwise_sqdist as j_pairwise_sqdist
    from occlusions4d_torch.ops.interpolate import knn_interpolate as t_knn_interpolate
    q = rng.rand(2, 40, 3).astype(np.float32) * 2 - 1
    k = rng.rand(2, 70, 3).astype(np.float32) * 2 - 1
    f = rng.randn(2, 70, 5).astype(np.float32)
    np.testing.assert_allclose(t_knn.pairwise_sqdist(_t(q), _t(k)).numpy(),
                               np.asarray(j_pairwise_sqdist(jnp.asarray(q), jnp.asarray(k))),
                               atol=ATOL, rtol=RTOL)
    ref = np.asarray(j_knn_interpolate(jnp.asarray(f), jnp.asarray(k), jnp.asarray(q), 3))
    out = t_knn_interpolate(_t(f), _t(k), _t(q), 3).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_hilbert_codes_match_jax(rng):
    pts = rng.rand(2, 257, 3).astype(np.float32) * 10 - 5
    lo, hi = pts.min(1, keepdims=True), pts.max(1, keepdims=True)
    jc = np.asarray(_hilbert_codes(jnp.asarray(pts), jnp.asarray(lo), jnp.asarray(hi)))
    tc = t_knn.hilbert_codes(_t(pts), _t(lo), _t(hi)).numpy()
    np.testing.assert_array_equal(tc, jc)


@pytest.mark.parametrize('case', ['plain', 'mask_start', 'n_out_one', 'ragged',
                                  'duplicates'])
def test_fps_matches_jax(rng, case):
    B, N, n_out = 2, 300, 64
    valid, start = None, None
    xyz = rng.rand(B, N, 3).astype(np.float32)
    if case == 'mask_start':
        valid = rng.rand(B, N) > 0.4
        start = np.array([np.flatnonzero(valid[b])[0] for b in range(B)], np.int32)
    elif case == 'n_out_one':
        n_out, start = 1, np.array([9, 4], np.int32)
    elif case == 'ragged':
        B, N, n_out = 1, 391, 137
        xyz = rng.rand(B, N, 3).astype(np.float32)
    elif case == 'duplicates':
        xyz = rng.randint(0, 4, size=(B, N, 3)).astype(np.float32)
        n_out = 40
    jkw = dict(valid=None if valid is None else jnp.asarray(valid),
               start_idx=None if start is None else jnp.asarray(start))
    tkw = dict(valid=None if valid is None else _t(valid),
               start_idx=None if start is None else _t(start))
    ref = np.asarray(j_fps_batched(jnp.asarray(xyz), n_out, use_pallas=False, **jkw))
    ref_pallas = np.asarray(j_fps_pallas(jnp.asarray(xyz), n_out, **jkw))
    out = t_fps_batched(_t(xyz), n_out, **tkw).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, ref_pallas)
    if valid is not None:
        assert all(valid[b][out[b]].all() for b in range(B))
    unsorted = t_fps_batched(_t(xyz), n_out, sort_result=False, **tkw).numpy()
    assert unsorted[0, 0] == (0 if start is None else start[0])


def test_interp_matches_jax(rng):
    q = rng.rand(1, 150, 3).astype(np.float32) * 2 - 1
    k = rng.rand(1, 60, 3).astype(np.float32) * 2 - 1
    f = rng.randn(1, 60, 24).astype(np.float32)
    mask = rng.rand(1, 60) > 0.2
    ref = np.asarray(j_fused_knn_interp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(f),
                                        8, key_mask=jnp.asarray(mask)))
    ref_mod = np.asarray(j_knn_interpolate(jnp.asarray(f), jnp.asarray(k),
                                           jnp.asarray(q), 8, eps=1e-4,
                                           key_mask=jnp.asarray(mask)))
    knn = t_attn.knn_extract(_t(q), _t(k), 14, key_mask=_t(mask))
    out = t_attn.fused_knn_interp(_t(q), _t(k), _t(f), 8, key_mask=_t(mask),
                                  knn=knn).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, ref_mod, atol=ATOL, rtol=RTOL)


def _attn_case(rng, N, M, D, E, K):
    import jax
    from occlusions4d_tpu.models.layers import VectorAttention
    x = rng.rand(1, N, D).astype(np.float32) - 0.5
    pos = rng.rand(1, N, 3).astype(np.float32) * 2 - 1
    x2 = rng.rand(1, M, E).astype(np.float32) - 0.5
    pos2 = rng.rand(1, M, 3).astype(np.float32) * 2 - 1
    mod = VectorAttention(dim=D, num_neighbors=K, dim2=E)
    variables = jax.jit(mod.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                  jnp.asarray(pos), x2=jnp.asarray(x2),
                                  pos2=jnp.asarray(pos2))
    p = jax.tree_util.tree_map(np.asarray, variables['params'])
    ref_mod = np.asarray(jax.jit(mod.apply)(variables, x, pos, x2=x2, pos2=pos2))
    qp = x @ p['to_q']['kernel']
    ref_fused = np.asarray(j_fused_attn(jnp.asarray(qp), jnp.asarray(pos),
                                        jnp.asarray(x2), jnp.asarray(pos2), p, K))
    tp = {n: {kk: _t(v) for kk, v in d.items()} for n, d in p.items()}
    return (qp, pos, x2, pos2, tp), ref_mod, ref_fused


@pytest.mark.parametrize('shape', [(96, 40, 32, 56, 6), (120, 300, 16, 16, 8)],
                         ids=['premul_rule', 'per_row_rule'])
def test_attention_matches_jax(rng, shape):
    N, M, D, E, K = shape
    (qp, pos, x2, pos2, tp), ref_mod, ref_fused = _attn_case(rng, N, M, D, E, K)
    np.testing.assert_allclose(ref_fused, ref_mod, atol=2e-5, rtol=1e-4)
    auto = t_attn.use_premul(M, D, E)
    assert auto == (shape[1] == 40)
    for premul in (True, False):  # both modes, whichever the rule picks.
        out = t_attn.fused_knn_vector_attention(_t(qp), _t(pos), _t(x2), _t(pos2),
                                                tp, K, premul=premul).numpy()
        np.testing.assert_allclose(out, ref_fused, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(out, ref_mod, atol=ATOL, rtol=RTOL)


def test_attention_plain_module_path_agree(rng):
    '''The port's VectorAttention (plain chain, module path) and its fused
    operator agree on the same weights and a masked key set.'''
    from occlusions4d_torch.models.layers import VectorAttention
    torch.manual_seed(0)
    N, M, D, E, K = 70, 50, 24, 20, 6
    att = VectorAttention(D, dim2=E, num_neighbors=K)
    x, pos = _t(rng.rand(1, N, D).astype(np.float32)), _t(rng.rand(1, N, 3).astype(np.float32))
    x2, pos2 = _t(rng.rand(1, M, E).astype(np.float32)), _t(rng.rand(1, M, 3).astype(np.float32))
    mask = _t(rng.rand(1, M) > 0.3)
    with torch.no_grad():
        ref = att(x, pos, x2=x2, pos2=pos2, key_mask=mask)
        out = t_attn.fused_knn_vector_attention(att.to_q(x), pos, x2, pos2,
                                                att.kernel_params(), K,
                                                key_mask=mask)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)


def test_cuda_entry_raises_without_cuda():
    '''Entry points never fall back to the CPU on their own.'''
    from occlusions4d_torch import resolve_device
    if torch.cuda.is_available():
        pytest.skip('CUDA present: nothing to refuse')
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device('cuda')
    assert resolve_device('cpu').type == 'cpu'


# ------------------------------------------------- backward operators (train) --
# Plain backward of the attention / interpolation operators (the CPU side of
# csrc/attn_bwd.cu and csrc/interp_bwd.cu) against the JAX custom-VJP
# kernels in interpret mode, at the shapes of tests/test_pallas_ops.py:181-243,
# for every live input. Tolerance atol 5e-6, rtol 2e-4 (the JAX tests' own).
GATOL, GRTOL = 5e-6, 2e-4


def _relu_margin(qp, pos, x2, pos2, p, K):
    '''Smallest |pre-activation| of the theta and gamma MLPs' ReLUs, in
    float64: the gradient jumps where one crosses zero, so two f32
    implementations may disagree on a row that sits within rounding of it.'''
    d = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    ki, _ = t_attn.knn_extract(_t(pos), _t(pos2), K)
    idx = ki[0].long()
    rel = d(pos)[0][:, None] - d(pos2)[0][idx]
    ph = rel @ d(p['pos_mlp_0']['kernel']) + d(p['pos_mlp_0']['bias'])
    pe = torch.relu(ph) @ d(p['pos_mlp_2']['kernel']) + d(p['pos_mlp_2']['bias'])
    f = d(x2)[0][idx]
    a = d(qp)[0][:, None] - f @ d(p['to_k']['kernel']) + pe
    h = a @ d(p['attn_mlp_0']['kernel']) + d(p['attn_mlp_0']['bias'])
    return min(float(ph.abs().min()), float(h.abs().min()))


@pytest.mark.parametrize('shape', [(96, 40, 32, 56, 6), (96, 50, 32, 24, 6)],
                         ids=['premul', 'per_row'])
def test_attention_grads_match_jax_vjp(shape):
    import jax
    rng = np.random.RandomState(5)
    N, M, D, E, K = shape
    x = rng.rand(1, N, D).astype(np.float32) - 0.5
    pos = rng.rand(1, N, 3).astype(np.float32) * 2 - 1
    x2 = rng.rand(1, M, E).astype(np.float32) - 0.5
    pos2 = rng.rand(1, M, 3).astype(np.float32) * 2 - 1
    w = rng.randn(1, N, D).astype(np.float32)
    p = {}
    for name, (di, do) in dict(pos_mlp_0=(3, 32), pos_mlp_2=(32, D), attn_mlp_0=(D, 2 * D),
                               attn_mlp_2=(2 * D, D)).items():
        p[name] = dict(kernel=rng.randn(di, do).astype(np.float32) * 0.1,
                       bias=rng.randn(do).astype(np.float32) * 0.01)
    for name in ('to_k', 'to_v'):
        p[name] = dict(kernel=rng.randn(E, D).astype(np.float32) * 0.1)
    qp = (x @ rng.randn(D, D).astype(np.float32) * 0.1).astype(np.float32)
    assert _relu_margin(qp, pos, x2, pos2, p, K) > 1e-6

    def loss(q, f, pp):
        return jnp.mean(j_fused_attn(q, jnp.asarray(pos), f, jnp.asarray(pos2), pp, K) * w)
    jg = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(qp), jnp.asarray(x2), jax.tree_util.tree_map(jnp.asarray, p))
    assert t_attn.use_premul(M, D, E) == (shape[1] == 40)
    tq = _t(qp).requires_grad_(True)
    tf = _t(x2).requires_grad_(True)
    tp = {n: {k: _t(v).requires_grad_(True) for k, v in d.items()} for n, d in p.items()}
    out = t_attn.fused_knn_vector_attention(tq, _t(pos), tf, _t(pos2), tp, K)
    (out * _t(w)).mean().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jg[0]), atol=GATOL, rtol=GRTOL)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jg[1]), atol=GATOL, rtol=GRTOL)
    for n, d in tp.items():
        for k, v in d.items():
            np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg[2][n][k]),
                                       atol=GATOL, rtol=GRTOL, err_msg=f'{n}/{k}')


@pytest.mark.parametrize('premul', [True, False])
def test_attn_bwd_plain_is_the_operator_gradient(rng, premul):
    '''attn_bwd (the CPU entry of kernel A's wrapper) returns what autograd
    through the operator gives, in the kernel's output layout.'''
    B, N, M, D, E, K = 2, 37, 23, 16, 12, 5
    q_pos, pos2 = _t(rng.rand(B, N, 3).astype(np.float32)), _t(rng.rand(B, M, 3).astype(np.float32))
    feats = _t(rng.randn(B, M, E).astype(np.float32))
    p = {n: {'kernel': _t(rng.randn(i, o).astype(np.float32) * 0.2)}
         for n, (i, o) in dict(to_k=(E, D), to_v=(E, D), pos_mlp_0=(3, 8), pos_mlp_2=(8, D),
                               attn_mlp_0=(D, 2 * D), attn_mlp_2=(2 * D, D)).items()}
    for n in ('pos_mlp_0', 'pos_mlp_2', 'attn_mlp_0', 'attn_mlp_2'):
        p[n]['bias'] = _t(rng.randn(p[n]['kernel'].shape[1]).astype(np.float32) * 0.1)
    ki, _ = t_attn.knn_extract(q_pos, pos2, K)
    kv = (torch.cat([feats @ p['to_k']['kernel'], feats @ p['to_v']['kernel']], -1)
          if premul else feats)
    q_proj = _t(rng.randn(B, N, D).astype(np.float32))
    g = _t(rng.randn(B, N, D).astype(np.float32))
    dq, dkv, dw = t_attn.attn_bwd(q_pos, q_proj, ki, pos2, kv, p, K, premul, g)
    assert dq.shape == q_proj.shape and dkv.shape == kv.shape
    names = {('pos_mlp_0', 'kernel'), ('pos_mlp_0', 'bias'), ('pos_mlp_2', 'kernel'),
             ('pos_mlp_2', 'bias'), ('attn_mlp_0', 'kernel'), ('attn_mlp_0', 'bias'),
             ('attn_mlp_2', 'kernel'), ('attn_mlp_2', 'bias')}
    if not premul:
        names |= {('to_k', 'kernel'), ('to_v', 'kernel')}
    assert set(dw) == names
    for (n, leaf), d in dw.items():
        assert d.shape == p[n][leaf].shape
    # The softmax over K is shift-invariant: the logits' bias gets no gradient.
    assert float(dw[('attn_mlp_2', 'bias')].abs().max()) < 1e-5


def test_interp_grads_match_jax_vjp(rng):
    import jax
    N, M, E, K = 130, 60, 24, 8
    q = rng.rand(1, N, 3).astype(np.float32) * 2 - 1
    k = rng.rand(1, M, 3).astype(np.float32) * 2 - 1
    f = rng.rand(1, M, E).astype(np.float32)
    mask = rng.rand(1, M) > 0.2
    w = rng.randn(1, N, E).astype(np.float32)
    jg = jax.jit(jax.grad(lambda ff: jnp.mean(j_fused_knn_interp(
        jnp.asarray(q), jnp.asarray(k), ff, K, eps=1e-4, key_mask=jnp.asarray(mask))
        * w)))(jnp.asarray(f))
    tf = _t(f).requires_grad_(True)
    out = t_attn.fused_knn_interp(_t(q), _t(k), tf, K, eps=1e-4, key_mask=_t(mask))
    (out * _t(w)).mean().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jg), atol=GATOL, rtol=GRTOL)
    # The CPU entry of kernel B's wrapper gives the same gradient.
    ki, kd = t_attn.knn_extract(_t(q), _t(k), 14, key_mask=_t(mask))
    d = t_attn.interp_bwd(ki, kd, _t(w) / w.size, M, K, 1e-4)
    np.testing.assert_allclose(d.numpy(), np.asarray(jg), atol=GATOL, rtol=GRTOL)


@pytest.mark.parametrize('case', ['random', 'empty_keys', 'one_key', 'many_tiles'])
def test_interp_bwd_inverse_index_equals_stable_argsort(rng, case):
    '''The counting sort of csrc/interp_bwd.cu, step by step in its plain
    version (per-tile ranks and counts, the scans, the placement), equals a
    stable argsort of the flat (B, N, k) neighbour keys, with per-key
    offsets from their counts: keys no query names (empty runs), one key
    holding every entry, entries spread over many tiles.'''
    B, N, KS, k, M, tile = 2, 301, 10, 8, 97, 2048
    ki = rng.randint(0, M, (B, N, KS))
    if case == 'empty_keys':
        M = 5000                                  # most keys have no entry.
        ki = rng.randint(0, 40, (B, N, KS)) * 100
    elif case == 'one_key':
        ki[:] = 3
    elif case == 'many_tiles':
        tile = 64
    ki = torch.tensor(ki, dtype=torch.int32)
    perm, offsets = t_attn.inverse_index_plain(ki, M, k, tile)
    keys = (ki[..., :k].long() + M * torch.arange(B)[:, None, None]).reshape(-1)
    ref = torch.argsort(keys, stable=True)
    counts = torch.bincount(keys, minlength=B * M)
    assert perm.dtype == offsets.dtype == torch.int32
    assert torch.equal(perm.long(), ref)
    assert torch.equal(torch.diff(offsets.long()), counts) and int(offsets[0]) == 0
    if case == 'one_key':
        assert int(counts.max()) == N * k and int((counts > 0).sum()) == B


def test_knn_extract_is_outside_autograd(rng):
    q = _t(rng.rand(1, 20, 3).astype(np.float32)).requires_grad_(True)
    k = _t(rng.rand(1, 15, 3).astype(np.float32)).requires_grad_(True)
    ki, kd = t_attn.knn_extract(q, k, 4)
    assert not kd.requires_grad and not ki.requires_grad


# ------------------------------------------------------ bidirectional 1-NN --

@pytest.mark.parametrize('case', ['masks_and_ties', 'no_masks'])
def test_nn1_bidirectional_matches_jax_exactly(rng, case):
    '''Integer coordinates make every product exact, so any summation order
    gives the same bits: duplicates and equidistant points tie, masks exclude.'''
    from occlusions4d_tpu.ops.knn import nn1_bidirectional as j_nn1
    a = rng.randint(-3, 4, size=(2, 170, 3)).astype(np.float32)
    b = rng.randint(-3, 4, size=(2, 230, 3)).astype(np.float32)
    b[:, :40] = a[:, :40]                                       # duplicates.
    am = bm = None
    if case == 'masks_and_ties':
        am, bm = rng.rand(2, 170) > 0.3, rng.rand(2, 230) > 0.3
        bm[1] = False                                           # one key set empty.
    ja, jb = j_nn1(jnp.asarray(a), jnp.asarray(b),
                   a_mask=None if am is None else jnp.asarray(am),
                   b_mask=None if bm is None else jnp.asarray(bm))
    ta, tb = t_knn.nn1_bidirectional(_t(a), _t(b), a_mask=None if am is None else _t(am),
                                     b_mask=None if bm is None else _t(bm))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    if case == 'masks_and_ties':
        assert np.isinf(ta.numpy()[1]).all()


def test_nn1_bidirectional_and_min_dist_match_jax_floats(rng):
    '''Random float clouds: XLA's dot may fuse multiply-adds the port keeps
    apart, so distances agree to f32 tolerance (atol 3e-5, rtol 1e-4).'''
    from occlusions4d_tpu.ops.knn import nn1_bidirectional as j_nn1, nn1_min_dist as j_md
    a = rng.rand(2, 300, 3).astype(np.float32) * 4 - 2
    b = rng.rand(2, 411, 3).astype(np.float32) * 4 - 2
    am, bm = rng.rand(2, 300) > 0.3, rng.rand(2, 411) > 0.3
    ja, jb = j_nn1(jnp.asarray(a), jnp.asarray(b), a_mask=jnp.asarray(am),
                   b_mask=jnp.asarray(bm))
    ta, tb = t_knn.nn1_bidirectional(_t(a), _t(b), a_mask=_t(am), b_mask=_t(bm))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=ATOL, rtol=RTOL)
    jd = j_md(jnp.asarray(a), jnp.asarray(b), key_mask=jnp.asarray(bm))
    td = t_knn.nn1_min_dist(_t(a), _t(b), key_mask=_t(bm))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL, rtol=RTOL)
    # The ranking values are the brute-force kNN's at k = 1, in both directions.
    an, bn = t_knn.sq_norm(_t(a)), t_knn.sq_norm(_t(b))
    bn = torch.where(_t(bm), bn, torch.full_like(bn, float('inf')))
    ra, _ = t_knn.nn1_bidir_plain(_t(a), an, _t(b), bn)
    da, _ = t_knn.knn_rank_plain(_t(a), _t(b), bn, 1)
    np.testing.assert_array_equal(ra.numpy(), da[..., 0].numpy())


# --------------------------------------------- selection, sampling, bounds --

@pytest.mark.parametrize('case', ['uniform', 'weighted', 'plateau', 'one_valid'])
def test_masked_choice_matches_jax_given_the_same_uniforms(rng, case):
    '''The inverse CDF (cumsum, cummax, scaled draws clamped below the top,
    right-searchsorted): fed JAX's own uniforms, the port picks the same
    indices wherever the two cumsums round alike. At 28672 thirds ('plateau')
    XLA's tree scan and torch's running sum round the cdf differently, so a
    draw on a step boundary may move to a neighbouring entry; every draw must
    still land on a positive-weight entry.'''
    import jax
    from occlusions4d_tpu.ops.select import masked_choice as j_mc
    from occlusions4d_torch.ops.select import masked_choice_from_uniforms
    n = 28672 if case == 'plateau' else 500
    valid = rng.rand(n) > 0.4
    w = None
    if case == 'weighted':
        w = rng.rand(n).astype(np.float32) * 3
    elif case == 'plateau':
        w = np.where(rng.rand(n) > 0.5, 1.0 / 3.0, 1e-3).astype(np.float32)
    elif case == 'one_valid':
        valid = np.zeros(n, bool)
        valid[137] = True
    key = jax.random.PRNGKey(11)
    ji, jok = j_mc(key, jnp.asarray(valid), 999, weights=None if w is None else jnp.asarray(w))
    u = np.asarray(jax.random.uniform(key, (999,), minval=0.0, maxval=1.0))
    ti, tok = masked_choice_from_uniforms(_t(valid)[None], _t(u)[None],
                                          None if w is None else _t(w)[None])
    ti = ti[0].numpy()
    if case == 'plateau':
        assert (ti != np.asarray(ji)).mean() < 0.01
    else:
        np.testing.assert_array_equal(ti, np.asarray(ji))
    assert bool(tok[0]) == bool(jok)
    assert valid[ti].all() and (w is None or (w[ti] > 0).all())


def test_valid_first_order_and_take_valid_match_jax(rng):
    from occlusions4d_tpu.ops.select import take_valid as j_take, valid_first_order as j_vfo
    from occlusions4d_torch.ops.select import take_valid, valid_first_order
    valid = rng.rand(3, 50) > 0.6
    valid[2] = False
    x = rng.randn(3, 50, 4).astype(np.float32)
    np.testing.assert_array_equal(valid_first_order(_t(valid)).numpy(),
                                  np.stack([np.asarray(j_vfo(jnp.asarray(v))) for v in valid]))
    rows, cnt = take_valid(_t(x), _t(valid), 40)
    for b in range(3):
        jr, jc = j_take(jnp.asarray(x[b]), jnp.asarray(valid[b]), 40)
        np.testing.assert_array_equal(rows[b].numpy(), np.asarray(jr))
        assert int(cnt[b]) == int(jc)


def test_bounds_and_masks_match_jax(rng):
    from occlusions4d_tpu.ops import bounds as jb
    from occlusions4d_torch.ops import bounds as tb
    pts = (rng.rand(2, 500, 3).astype(np.float32) * 50 - 20)
    for mode in (1, 2, 3, 4):
        for fn in ('carla_input_bounds', 'carla_output_bounds'):
            jc = getattr(jb, fn)(16.0, -0.5, mode)
            tc = getattr(tb, fn)(16.0, -0.5, mode)
            assert tuple(jc) == tuple(tc)
            np.testing.assert_array_equal(tb.cuboid_mask(_t(pts), tc).numpy(),
                                          np.asarray(jb.cuboid_mask(jnp.asarray(pts), jc)))
    assert tuple(tb.greater_bounds(5.0, -1.0)) == tuple(jb.greater_bounds(5.0, -1.0))
    np.testing.assert_array_equal(tb.greater_floor_mask(_t(pts)).numpy(),
                                  np.asarray(jb.greater_floor_mask(jnp.asarray(pts))))
    np.testing.assert_array_equal(tb.greater_floor_mask(pts), jb.greater_floor_mask(pts))


def test_device_sampling_laws():
    '''3-ball jitter stays in its shell and blind points in their cuboid
    (the JAX package's laws; the numbers differ, the generator being torch's).'''
    from occlusions4d_torch.ops.bounds import Cuboid
    from occlusions4d_torch.ops.sampling import sample_blind_random, sample_uniform_3ball
    gen = torch.Generator().manual_seed(0)
    v = sample_uniform_3ball(gen, (2, 4000), 0.6, 0.2)
    r = torch.linalg.vector_norm(v, dim=-1)
    assert v.shape == (2, 4000, 3) and float(r.min()) >= 0.2 - 1e-6 and float(r.max()) <= 0.6 + 1e-6
    # Cube-root law: the median radius of the full-ball part sits at 0.5^(1/3).
    assert abs(float(torch.median(sample_uniform_3ball(gen, (20000,), 1.0).norm(dim=-1)))
               - 0.5 ** (1 / 3)) < 0.02
    c = Cuboid(-1.0, 2.0, 0.0, 1.0, -3.0, -2.0)
    p = sample_blind_random(gen, (3, 1000), c)
    assert float(p[..., 0].min()) >= -1 and float(p[..., 0].max()) <= 2
    assert float(p[..., 2].min()) >= -3 and float(p[..., 2].max()) <= -2


def test_random_fps_starts():
    from occlusions4d_torch.ops.fps import random_start_indices
    gen = torch.Generator().manual_seed(1)
    s = random_start_indices(gen, 4000, 37)
    assert s.shape == (4000,) and int(s.min()) == 0 and int(s.max()) == 36
    valid = torch.zeros(4000, 37, dtype=torch.bool)
    valid[:, 5] = valid[:, 30] = True
    s = random_start_indices(gen, 4000, 37, valid=valid)
    assert set(s.tolist()) == {5, 30}
