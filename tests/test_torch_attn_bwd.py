'''
The attention backward's decomposition (csrc/attn_bwd.cu: chunks of whole
queries, a row phase, then the weight gradients as long-K sums over row
slices added in order) held against the JAX package on the CPU, through its
plain PyTorch spelling attn_bwd_rows_plain: against jax.vjp of
fused_knn_vector_attention in its gathered and index forms (the
_attn_g_bwd and _attn_bwd Pallas kernels in interpret mode, as the JAX
package's own tests run them) and against the port's plain backward
versions (autograd through the forward). Inputs are made with numpy from a
seed and handed to both. Also the 3xTF32 split the kernel multiplies with,
emulated with bit masks, against float64 sums at the card's tolerance.

Tolerances, each with its reason:
  * against JAX: atol 5e-6, rtol 2e-4, the JAX gradient tests' own
    (summation order and fused multiply-adds between XLA and PyTorch);
  * against the port's plain versions: atol 5e-6 x max(1, max|plain|), the
    card's tolerance for the backward kernels (chip_smoke.py), since the
    decomposition only reorders the same f32 sums;
  * the 3xTF32 emulation: 5e-6 x max(1, max|exact|) over 10^4-row sums and
    over a weight gradient's row slice (8 x 10^4 rows) in the wgmma engine's
    order (fragments of 64 rows, truncated, promoted into the f32 sum), the
    same scaled tolerance.
'''

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from occlusions4d_tpu.ops import pallas_attention as j_pa

from test_torch_cv1 import _attn_params, _cloud, _t

t_attn = importlib.import_module('occlusions4d_torch.ops.attention')

GATOL, GRTOL = 5e-6, 2e-4


def _tp(p):
    return {n: {leaf: _t(v) for leaf, v in d.items()} for n, d in p.items()}


def _case(B, K, N=45, M=60, D=16, E=12, seed=0):
    rng = np.random.RandomState(100 * B + K + seed)
    q, pos2 = _cloud(rng, B, N, 3), _cloud(rng, B, M, 3)
    feats = rng.randn(B, M, E).astype(np.float32)
    q_proj = rng.randn(B, N, D).astype(np.float32)
    go = rng.randn(B, N, D).astype(np.float32)
    p = _attn_params(rng, D, E)
    return dict(B=B, N=N, M=M, D=D, E=E, K=K, q=q, pos2=pos2, feats=feats, q_proj=q_proj,
                go=go, p=p)


def _rows_of_knn(c, ki):
    '''rel (B, N, k, 3) and the raw feature rows (B, N, k, E) of the index
    route, as the kernel's row loader forms them.'''
    pos2, feats = _t(c['pos2']), _t(c['feats'])
    rel = _t(c['q'])[:, :, None, :] - t_attn.gather_neighbors(pos2, ki)
    return rel, t_attn.gather_neighbors(feats, ki)


def _scatter_rows(ki, drows, M):
    '''d(feats2) of the index route: the rows' gradients summed per key.'''
    B, N, k, C = drows.shape
    out = torch.zeros((B, M, C))
    idx = ki.reshape(B, N * k, 1).long().expand(B, N * k, C)
    return out.scatter_add_(1, idx, drows.reshape(B, N * k, C))


def _assert_close_jax(port, ref, what):
    np.testing.assert_allclose(port, np.asarray(ref), atol=GATOL, rtol=GRTOL,
                               err_msg=what)


def _assert_scaled(a, b, what):
    scale = max(1.0, float(b.abs().max()))
    err = float((a - b).abs().max())
    assert err <= 5e-6 * scale, f'{what}: {err} > 5e-6 x {scale}'


@pytest.mark.parametrize('B', [1, 3])
@pytest.mark.parametrize('K', [14, 16])
def test_decomposition_matches_jax_gathered_form(B, K):
    '''Several chunks with a ragged last one (45 queries in chunks of 8): the
    rows' gradients, d(q_proj) and every weight gradient against jax.vjp of
    the gathered attention.'''
    c = _case(B, K)
    N, E = c['N'], c['E']
    k_ext = K + 2
    jknn = j_pa.knn_extract(jnp.asarray(c['q']), jnp.asarray(c['pos2']), k_ext)
    jg = j_pa.knn_gather_rows(jnp.asarray(c['pos2']), jnp.asarray(c['feats']), jknn, k_ext)
    _, vjp = jax.vjp(lambda qp, gg, pp: j_pa.fused_knn_vector_attention(
        qp, jnp.asarray(c['q']), jnp.asarray(c['feats']), jnp.asarray(c['pos2']), pp, K,
        knn=jknn, gathered=gg), jnp.asarray(c['q_proj']), jg,
        jax.tree_util.tree_map(jnp.asarray, c['p']))
    jdq, jdg, jdw = vjp(jnp.asarray(c['go']))
    tknn = t_attn.knn_extract(_t(c['q']), _t(c['pos2']), k_ext)
    g = t_attn.knn_gather_rows(_t(c['pos2']), _t(c['feats']), tknn, k_ext)
    rows = g[:, :K].transpose(1, 2)
    rel = _t(c['q'])[:, :, None, :] - rows[..., E:]
    dq, drows, dw = t_attn.attn_bwd_rows_plain(_t(c['q_proj']), rel, rows[..., :E],
                                               _tp(c['p']), _t(c['go']), False, qc=8)
    _assert_close_jax(dq.numpy(), jdq, 'dq')
    ref = np.asarray(jdg)[:, :K, :N, :E]
    _assert_close_jax(drows.transpose(1, 2).numpy(), ref, 'rows')
    for (n, leaf), v in dw.items():
        _assert_close_jax(v.numpy(), jdw[n][leaf], f'{n}/{leaf}')
    assert set(dw) == {(n, leaf) for n, d in c['p'].items() for leaf in d}


@pytest.mark.parametrize('B', [1, 3])
@pytest.mark.parametrize('K', [14, 16])
def test_decomposition_matches_jax_index_form(B, K):
    '''The index route (per-row rows from the key set, their gradients
    summed per key into d(feats2)) against jax.vjp of the index form.'''
    c = _case(B, K, seed=1)
    M = c['M']
    jknn = j_pa.knn_extract(jnp.asarray(c['q']), jnp.asarray(c['pos2']), K)
    _, vjp = jax.vjp(lambda qp, f, pp: j_pa.fused_knn_vector_attention(
        qp, jnp.asarray(c['q']), f, jnp.asarray(c['pos2']), pp, K, knn=jknn),
        jnp.asarray(c['q_proj']), jnp.asarray(c['feats']),
        jax.tree_util.tree_map(jnp.asarray, c['p']))
    jdq, jdf, jdw = vjp(jnp.asarray(c['go']))
    ki, _ = t_attn.knn_extract(_t(c['q']), _t(c['pos2']), K)
    rel, rows = _rows_of_knn(c, ki)
    dq, drows, dw = t_attn.attn_bwd_rows_plain(_t(c['q_proj']), rel, rows, _tp(c['p']),
                                               _t(c['go']), False, qc=7, slices=3)
    _assert_close_jax(dq.numpy(), jdq, 'dq')
    _assert_close_jax(_scatter_rows(ki, drows, M).numpy(), jdf, 'dfeats')
    for (n, leaf), v in dw.items():
        _assert_close_jax(v.numpy(), jdw[n][leaf], f'{n}/{leaf}')


@pytest.mark.parametrize('premul', [True, False])
@pytest.mark.parametrize('qc', [1, 11, 45])
def test_decomposition_matches_attn_bwd_plain(premul, qc):
    '''Against the port's plain index-route backward in both projection
    modes: one query per chunk, ragged chunks of 11, and one chunk.'''
    c = _case(3, 14, seed=2)
    M = c['M']
    tp = _tp(c['p'])
    ki, _ = t_attn.knn_extract(_t(c['q']), _t(c['pos2']), 14)
    feats = _t(c['feats'])
    kv = (torch.cat([feats @ tp['to_k']['kernel'], feats @ tp['to_v']['kernel']], -1)
          if premul else feats)
    rq, rkv, rw = t_attn.attn_bwd_plain(_t(c['q']), _t(c['q_proj']), ki, _t(c['pos2']), kv,
                                        tp, 14, premul, _t(c['go']))
    rel = _t(c['q'])[:, :, None, :] - t_attn.gather_neighbors(_t(c['pos2']), ki)
    dq, drows, dw = t_attn.attn_bwd_rows_plain(_t(c['q_proj']), rel,
                                               t_attn.gather_neighbors(kv, ki), tp,
                                               _t(c['go']), premul, qc=qc)
    _assert_scaled(dq, rq, 'dq')
    _assert_scaled(_scatter_rows(ki, drows, M), rkv, 'dkv')
    assert set(dw) == set(rw)
    for nl in rw:
        _assert_scaled(dw[nl], rw[nl], str(nl))


@pytest.mark.parametrize('K', [1, 14, 32])
def test_decomposition_matches_attn_g_bwd_plain(K):
    '''Against the port's plain gathered backward, the rows gathered at
    K_ext > K (the rows past K get no gradient), B 1, chunks of 6.'''
    c = _case(1, K, N=40, M=50, seed=3)
    E, N = c['E'], c['N']
    tp = _tp(c['p'])
    tknn = t_attn.knn_extract(_t(c['q']), _t(c['pos2']), K)
    g = t_attn.knn_gather_rows(_t(c['pos2']), _t(c['feats']), tknn, K)
    extra = np.random.RandomState(4).randn(1, 2, N, E + 3).astype(np.float32)
    g = torch.cat([g, _t(extra)], dim=1)  # K_ext = K + 2.
    rq, rg, rw = t_attn.attn_g_bwd_plain(_t(c['q']), _t(c['q_proj']), g, tp, K,
                                         _t(c['go']))
    rows = g[:, :K].transpose(1, 2)
    rel = _t(c['q'])[:, :, None, :] - rows[..., E:]
    dq, drows, dw = t_attn.attn_bwd_rows_plain(_t(c['q_proj']), rel, rows[..., :E], tp,
                                               _t(c['go']), False, qc=6)
    _assert_scaled(dq, rq, 'dq')
    _assert_scaled(drows.transpose(1, 2), rg[:, :K, :, :E], 'dg')
    assert not rg[:, K:].any() and not rg[..., E:].any()
    for nl in rw:
        _assert_scaled(dw[nl], rw[nl], str(nl))


def _tf32(x):
    '''Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does: add half a TF32 ulp to the
    magnitude's bits and clear the 13 low bits.'''
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32((x - big).astype(np.float32))


def _round_toward_zero(x):
    '''float64 values rounded to float32 toward zero (the tensor core's own
    accumulation truncates).'''
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _staged_products(pairs, R, depth=64):
    '''X^T Y in the wgmma engine's order (csrc/attn_common.cuh): per 8-deep
    step the products of `pairs` ((x part, y part), in order), each an exact
    8-deep sum added to the fragment with truncation; the fragment starts
    from zero each `depth` rows (the engine's promotion depth: two 32-deep
    k-steps) and is then added to the float32 sum, rounded to nearest.'''
    steps = R // 8
    terms = [np.einsum('skc,skn->scn', a.reshape(steps, 8, -1).astype(np.float64),
                       b.reshape(steps, 8, -1).astype(np.float64)) for a, b in pairs]
    per = depth // 8
    acc = np.zeros(terms[0].shape[1:], np.float32)
    for s0 in range(0, steps, per):
        frag = np.zeros_like(acc)
        for st in range(s0, min(steps, s0 + per)):
            for t in terms:
                frag = _round_toward_zero(frag.astype(np.float64) + t[st])
        acc = acc + frag
    return acc


# (scale, order, rows): 'sum' takes each of the three products whole in f32;
# 'stage' is the wgmma engine's order (_staged_products), at 10^4 rows and
# at a weight gradient's row slice (about 8 x 10^4 rows at the train cells).
_TF32_CASES = [(1.0, 'sum', 10000), (1e-3, 'sum', 10000), (300.0, 'sum', 10000),
               (1.0, 'stage', 10000), (1e-3, 'stage', 10000), (300.0, 'stage', 10000),
               (1.0, 'stage', 80000), (1e-3, 'stage', 80000), (300.0, 'stage', 80000)]
_TF32_IDS = ['1.0', '0.001', '300.0'] + [f'{o}-{r}-{s}' for s, o, r in _TF32_CASES[3:]]


@pytest.mark.parametrize('scale, order, R', _TF32_CASES, ids=_TF32_IDS)
def test_3xtf32_products_stay_within_the_card_tolerance(scale, order, R):
    '''A weight gradient's shape of sum: X^T Y over R rows, each product as
    small_a big_b + big_a small_b + big_a big_b (the kernel's order), against
    float64; plain TF32 (big_a big_b alone) misses it. 'sum': each product
    summed whole in f32; 'stage': the wgmma engine's fragments of 64 rows
    promoted into the f32 sum.'''
    rng = np.random.RandomState(7)
    K1, N = 24, 20
    X = (rng.randn(R, K1) * scale).astype(np.float32)
    Y = rng.randn(R, N).astype(np.float32)
    Xb, Xs = _split(X)
    Yb, Ys = _split(Y)
    exact = X.astype(np.float64).T @ Y.astype(np.float64)
    if order == 'sum':
        f32 = lambda a, b: (torch.tensor(a).T @ torch.tensor(b)).numpy()  # noqa: E731
        three = (f32(Xs, Yb) + f32(Xb, Ys)) + f32(Xb, Yb)
        one = f32(Xb, Yb)
    else:
        three = _staged_products([(Xs, Yb), (Xb, Ys), (Xb, Yb)], R)
        one = _staged_products([(Xb, Yb)], R)
    tol = 5e-6 * max(1.0, float(np.abs(exact).max()))
    assert float(np.abs(three - exact).max()) <= tol
    assert float(np.abs(one - exact).max()) > tol
    # The split is exact: big + small recovers x up to the residual's
    # rounding, far below f32's own precision of the sums.
    assert float(np.abs((Xb.astype(np.float64) + Xs) - X).max()) <= \
        2.0 ** -21 * float(np.abs(X).max())
