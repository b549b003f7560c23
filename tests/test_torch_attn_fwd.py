'''
The attention forward's decomposition (csrc/attn.cu o4d_attn and o4d_attn_g:
chunks of whole queries, tiles of 64 rows, gamma in chunks of 128 hidden
columns with the logits one running sum, the softmax and weighted sum per
channel in j order) held against the JAX package on the CPU, through its
plain PyTorch spelling attn_fwd_rows_plain: against fused_knn_vector_attention
in its index form (premul and per-row, _attn_kernel in interpret mode) and its
gathered form (_attn_g_kernel), as the JAX package's own tests run them; and
against the port's plain versions attn_plain and attn_g_plain. Inputs are
made with numpy from a seed and handed to both. Also the kernel's 3xTF32
products, emulated with bit masks and the tensor core's running sum across
the whole K (each mma's exact sum rounded toward zero), at the card's
tolerance.

Tolerances, each with its reason:
  * against JAX and the port's plain versions: atol 3e-5, rtol 1e-4, the JAX
    tests' f32 CPU tolerance (summation order and fused multiply-adds
    between XLA and PyTorch, and the decomposition's chunked gamma sums);
  * the 3xTF32 emulation: atol 1e-4, rtol 1e-3 against float64, the card's
    tolerance for the forward kernels (chip_smoke.py, test_torch_cuda.py).
'''

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from occlusions4d_tpu.ops import pallas_attention as j_pa

from test_torch_attn_bwd import _split
from test_torch_cv1 import _attn_params, _cloud, _t

t_attn = importlib.import_module('occlusions4d_torch.ops.attention')

ATOL, RTOL = 3e-5, 1e-4


def _tp(p):
    return {n: {leaf: _t(v) for leaf, v in d.items()} for n, d in p.items()}


def _case(B, K, N=45, M=80, D=16, E=12, seed=0):
    rng = np.random.RandomState(200 * B + K + seed)
    q, pos2 = _cloud(rng, B, N, 3), _cloud(rng, B, M, 3)
    return dict(B=B, N=N, M=M, D=D, E=E, K=K, q=q, pos2=pos2,
                feats=rng.randn(B, M, E).astype(np.float32),
                q_proj=rng.randn(B, N, D).astype(np.float32),
                mask=rng.rand(B, M) > 0.2, p=_attn_params(rng, D, E))


def _index_rows(c, ki, premul, tp):
    '''rel and the rows of the index route, as the kernel's row loader forms
    them: kv = [F Wk | F Wv] (premul) or F, gathered by ki.'''
    feats = _t(c['feats'])
    kv = (torch.cat([feats @ tp['to_k']['kernel'], feats @ tp['to_v']['kernel']], -1)
          if premul else feats)
    rel = _t(c['q'])[:, :, None, :] - t_attn.gather_neighbors(_t(c['pos2']), ki)
    return rel, t_attn.gather_neighbors(kv, ki), kv


def _gathered_rows(c, g, K):
    '''rel and the features of the gathered form's rows g (B, KE, N, E + 3).'''
    E = c['E']
    rows = g[:, :K].transpose(1, 2)
    return _t(c['q'])[:, :, None, :] - rows[..., E:], rows[..., :E]


@pytest.mark.parametrize('premul', [True, False])
@pytest.mark.parametrize('K', [1, 6, 14, 32])
def test_fwd_decomposition_matches_jax_index_form(premul, K, monkeypatch):
    '''B 2, 45 queries (ragged chunks of 8 and tiles of 64 rows), masked
    keys, both projection modes (JAX's placement forced to match).'''
    monkeypatch.setattr(j_pa, 'FORCE_PREMUL', premul)
    c = _case(2, K)
    jknn = j_pa.knn_extract(jnp.asarray(c['q']), jnp.asarray(c['pos2']), K,
                            key_mask=jnp.asarray(c['mask']))
    ref = np.asarray(j_pa.fused_knn_vector_attention(
        jnp.asarray(c['q_proj']), jnp.asarray(c['q']), jnp.asarray(c['feats']),
        jnp.asarray(c['pos2']), jax.tree_util.tree_map(jnp.asarray, c['p']), K,
        key_mask=jnp.asarray(c['mask']), knn=jknn))
    tp = _tp(c['p'])
    ki, _ = t_attn.knn_extract(_t(c['q']), _t(c['pos2']), K, key_mask=_t(c['mask']))
    rel, rows, _ = _index_rows(c, ki, premul, tp)
    out = t_attn.attn_fwd_rows_plain(_t(c['q_proj']), rel, rows, tp, premul, qc=8)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('K', [1, 14, 30])
def test_fwd_decomposition_matches_jax_gathered_form(K):
    '''The rows gathered at K_ext = K + 2 > K (JAX's kNN takes at most 32),
    masked keys, B 2, chunks of 7 queries.'''
    c = _case(2, K, seed=1)
    k_ext = K + 2
    jknn = j_pa.knn_extract(jnp.asarray(c['q']), jnp.asarray(c['pos2']), k_ext,
                            key_mask=jnp.asarray(c['mask']))
    jg = j_pa.knn_gather_rows(jnp.asarray(c['pos2']), jnp.asarray(c['feats']), jknn, k_ext)
    ref = np.asarray(j_pa.fused_knn_vector_attention(
        jnp.asarray(c['q_proj']), jnp.asarray(c['q']), jnp.asarray(c['feats']),
        jnp.asarray(c['pos2']), jax.tree_util.tree_map(jnp.asarray, c['p']), K,
        key_mask=jnp.asarray(c['mask']), knn=jknn, gathered=jg))
    tknn = t_attn.knn_extract(_t(c['q']), _t(c['pos2']), k_ext, key_mask=_t(c['mask']))
    g = t_attn.knn_gather_rows(_t(c['pos2']), _t(c['feats']), tknn, k_ext)
    rel, rows = _gathered_rows(c, g, K)
    out = t_attn.attn_fwd_rows_plain(_t(c['q_proj']), rel, rows, _tp(c['p']), False, qc=7)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('premul', [True, False])
@pytest.mark.parametrize('qc', [1, 11, 45])
def test_fwd_decomposition_matches_attn_plain(premul, qc):
    '''Against the port's plain index-route forward: one query per chunk,
    ragged chunks of 11, one chunk; k 14 (tiles of 64 rows cut queries).'''
    c = _case(2, 14, seed=2)
    tp = _tp(c['p'])
    ki, _ = t_attn.knn_extract(_t(c['q']), _t(c['pos2']), 14, key_mask=_t(c['mask']))
    rel, rows, kv = _index_rows(c, ki, premul, tp)
    ref = t_attn.attn_plain(_t(c['q']), _t(c['q_proj']), ki, _t(c['pos2']), kv, tp, 14,
                            premul)
    out = t_attn.attn_fwd_rows_plain(_t(c['q_proj']), rel, rows, tp, premul, qc=qc)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('K', [1, 6, 32])
def test_fwd_decomposition_matches_attn_g_plain_and_index_route(K):
    '''Against the port's plain gathered forward, the rows gathered at
    K_ext > K (k 1 and 6; k 32 at K_ext 32); on the same rows the index
    route's per-row decomposition gives the same bits (the kernels are
    row-local).'''
    c = _case(1, K, N=40, seed=3)
    tp = _tp(c['p'])
    k_ext = min(K + 3, 32)
    tknn = t_attn.knn_extract(_t(c['q']), _t(c['pos2']), k_ext, key_mask=_t(c['mask']))
    g = t_attn.knn_gather_rows(_t(c['pos2']), _t(c['feats']), tknn, k_ext)
    ref = t_attn.attn_g_plain(_t(c['q']), _t(c['q_proj']), g, tp, K)
    rel, rows = _gathered_rows(c, g, K)
    out = t_attn.attn_fwd_rows_plain(_t(c['q_proj']), rel, rows, tp, False, qc=6)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)
    irel, irows, _ = _index_rows(c, tknn[0][..., :K], False, tp)
    idx = t_attn.attn_fwd_rows_plain(_t(c['q_proj']), irel, irows, tp, False, qc=6)
    assert torch.equal(out, idx)


def _rz32(x):
    '''float64 -> float32 rounded toward zero.'''
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _mma_3xtf32(a, b, c):
    '''c + a b as the kernel's tensor cores form it: a and b split into TF32
    (big, small); per 8-deep step three mma products small_a big_b, big_a
    small_b, big_a big_b, each mma adding its exact 8-term sum to the running
    sum and rounding toward zero; the running sum spans the whole K.'''
    a, b = a.numpy(), b.numpy()
    ab, asm = _split(a)
    bb, bsm = _split(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32) if c is None else c.numpy().copy()
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        for x, y in ((asm, bb), (ab, bsm), (ab, bb)):
            acc = _rz32(acc.astype(np.float64) + x[:, s].astype(np.float64) @ y[s].astype(
                np.float64))
    return torch.from_numpy(acc)


@pytest.mark.parametrize('premul', [True, False])
def test_fwd_3xtf32_products_stay_within_the_card_tolerance(premul):
    '''Gamma (K 104 and 208 deep) and, per-row, F Wk and F Wv on emulated
    tensor cores, summed across the whole K without f32 adds between the
    steps, against the decomposition in float64: within the card's
    tolerance. TF32 alone (big_a big_b) would sit at about 1e-3 of each
    product; the split recovers f32's precision.'''
    rng = np.random.RandomState(11)
    B, N, M, D, E, K = 1, 12, 60, 104, 72, 14
    q, pos2 = _cloud(rng, B, N, 3), _cloud(rng, B, M, 3)
    feats = rng.randn(B, M, E).astype(np.float32)
    q_proj = rng.randn(B, N, D).astype(np.float32)
    p = _attn_params(rng, D, E)
    c = dict(q=q, pos2=pos2, feats=feats, E=E)
    tp = _tp(p)
    ki, _ = t_attn.knn_extract(_t(q), _t(pos2), K)
    rel, rows, _ = _index_rows(c, ki, premul, tp)
    emu = t_attn.attn_fwd_rows_plain(_t(q_proj), rel, rows, tp, premul, qc=5,
                                     product=_mma_3xtf32)
    tp64 = {n: {leaf: v.double() for leaf, v in d.items()} for n, d in tp.items()}
    exact = t_attn.attn_fwd_rows_plain(_t(q_proj).double(), rel.double(), rows.double(),
                                       tp64, premul, qc=5)
    np.testing.assert_allclose(emu.numpy(), exact.numpy(), atol=1e-4, rtol=1e-3)
    # And far tighter than the tolerance: f32's precision, not TF32's.
    assert float((emu.double() - exact).abs().max()) < 1e-5 * float(exact.abs().max())
