'''
The encoder's fused self-attention forward as the card runs it since the
attention forward's pipeline took it over (csrc/attn.cu o4d_sattn and
o4d_sattn_bf16, run_fwd<kSelf>: chunks of whole queries, tiles of 64 rows,
gamma in chunks of 128 hidden columns with the logits one running sum, the
softmax and weighted sum per channel in j order), held against the JAX
package on the CPU through its plain PyTorch spelling attn_fwd_rows_plain
over gf and rel as given: against fused_gathered_attention (its _fwd_kernel
in interpret mode, as the JAX package's own tests run it), in f32 and with
compute_dtype=bfloat16, and against the port's plain sattn_plain. Also the
tile's 3xTF32 products, emulated with bit masks and the tensor core's running
sum across the whole K, at the card's tolerance; and the gathered
interpolation's backward (o4d_interp_g_bwd, which writes a group of
queries' rows as one run per plane) at the query counts and k that its
grouping makes edges. Inputs and weights are made with numpy from a seed and
handed to both; where the block is a module's (D = E), the weights cross
through checkpoint.from_jax_params.

Tolerances, each with its reason:
  * f32 decomposition against JAX and the port's plain version: atol 3e-5,
    rtol 1e-4, as tests/test_torch_attn_fwd.py (summation order and fused
    multiply-adds between XLA and PyTorch, the chunked gamma sums);
  * the 3xTF32 emulation: atol 1e-4, rtol 1e-3 against float64, the card's
    tolerance for the forward kernels (chip_smoke.py, test_torch_cuda.py);
  * bf16 decomposition against JAX's bf16 kernel: relative L2 1e-4, the gate
    of tests/test_torch_mixed_precision.py (both sum exact products of the
    same bf16 operands in f32, in another order); the f32 decomposition lands
    outside it;
  * interp_g_bwd_plain against jax.vjp of fused_knn_interp(gathered=): atol
    5e-6, rtol 2e-4 (tests/test_torch_cv1_train.py), the zero rows and
    position columns exact.
'''

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# Six test workers share eight cores: keep PyTorch's CPU pool small.
torch.set_num_threads(2)

from occlusions4d_tpu.ops import pallas_attention as j_pa
from occlusions4d_tpu.ops.pallas_self_attention import fused_gathered_attention as j_fga
from occlusions4d_torch.checkpoint import from_jax_params
from occlusions4d_torch.models import VectorAttention

from test_torch_attn_fwd import _mma_3xtf32
from test_torch_cv1 import _cloud
from test_torch_sattn import _case

t_attn = importlib.import_module('occlusions4d_torch.ops.attention')
t_sattn = importlib.import_module('occlusions4d_torch.ops.self_attention')

ATOL, RTOL = 3e-5, 1e-4
FTOL = 1e-4
GATOL, GRTOL = 5e-6, 2e-4


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port_params(p, D, E):
    '''The weights in the port: through checkpoint.from_jax_params into a
    VectorAttention where the block is a module's (D = E), as given
    otherwise.'''
    if D != E:
        return {n: {leaf: _t(v) for leaf, v in d.items()} for n, d in p.items()}
    rng = np.random.RandomState(D)
    tree = dict(p, to_q={'kernel': rng.randn(D, D).astype(np.float32)})
    mod = VectorAttention(D, num_neighbors=8, fused='on')
    mod.load_state_dict(from_jax_params(tree, mod), strict=True)
    return {n: {leaf: t.detach() for leaf, t in d.items()}
            for n, d in mod.kernel_params().items()}


def _jax_fwd(q, gf, rel, p, K, compute_dtype=jnp.float32):
    return np.asarray(j_fga(jnp.asarray(q), jnp.asarray(gf), jnp.asarray(rel),
                            jax.tree_util.tree_map(jnp.asarray, p), K,
                            compute_dtype=compute_dtype))


# (K, D, E, N, qc): K 8 / 16 / 32; D = E at small stand-ins for the encoder's
# widths (24 for 36, 40 for 72), E != D both ways; N ragged against the tile
# of 64 rows and the chunks; qc below N (several chunks, the last short) and
# qc = N (one chunk).
_CASES = {'k8_d24': (8, 24, 24, 37, 10), 'k16_d24': (16, 24, 24, 37, 37),
          'k32_d40': (32, 40, 40, 29, 7), 'k16_d40': (16, 40, 40, 45, 16),
          'k8_d24_e40': (8, 24, 40, 37, 9), 'k16_d40_e16': (16, 40, 16, 41, 41)}


@pytest.mark.parametrize('case', sorted(_CASES))
def test_sattn_fwd_decomposition_matches_jax(case):
    '''attn_fwd_rows_plain(q, rel, gf, premul=False, qc), the chunks, tiles
    and hidden chunks of o4d_sattn, against JAX fused_gathered_attention and
    the port's sattn_plain, B 2.'''
    K, D, E, N, qc = _CASES[case]
    q, gf, rel, p = _case(K * D + E + N, 2, N, K, D, E)
    ref = _jax_fwd(q, gf, rel, p, K)
    tp = _port_params(p, D, E)
    out = t_attn.attn_fwd_rows_plain(_t(q), _t(rel), _t(gf), tp, False, qc=qc)
    assert out.shape == ref.shape == (2, N, D)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    plain = t_sattn.sattn_plain(_t(q), _t(gf), _t(rel), tp)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('K,D,E', [(16, 72, 72), (8, 40, 72)])
def test_sattn_fwd_3xtf32_products_stay_within_the_card_tolerance(K, D, E):
    '''The tile's products (F Wk, F Wv, gamma, K 72 to 144 deep) on emulated
    tensor cores, summed across the whole K, against the decomposition in
    float64: within the card's tolerance, and far tighter (f32's precision,
    not TF32's).'''
    q, gf, rel, p = _case(7 + K + D + E, 1, 9, K, D, E)
    tp = {n: {leaf: _t(v) for leaf, v in d.items()} for n, d in p.items()}
    emu = t_attn.attn_fwd_rows_plain(_t(q), _t(rel), _t(gf), tp, False, qc=4,
                                     product=_mma_3xtf32)
    tp64 = {n: {leaf: v.double() for leaf, v in d.items()} for n, d in tp.items()}
    exact = t_attn.attn_fwd_rows_plain(_t(q).double(), _t(rel).double(), _t(gf).double(),
                                       tp64, False, qc=4)
    np.testing.assert_allclose(emu.numpy(), exact.numpy(), atol=1e-4, rtol=1e-3)
    assert float((emu.double() - exact).abs().max()) < 1e-5 * float(exact.abs().max())


@pytest.mark.parametrize('case', ['k8_d24', 'k16_d40', 'k8_d24_e40', 'k16_d40_e16'])
def test_sattn_bf16_fwd_decomposition_matches_jax(case):
    '''The decomposition in the bf16 mode (o4d_sattn_bf16's roundings: rel,
    theta's hidden layer, F, hpre, h and the weight kernels, every sum f32)
    against JAX fused_gathered_attention(compute_dtype=jnp.bfloat16), gf and
    the weight kernels rounded as the port's operator hands them over; the
    f32 decomposition fails the same gate.'''
    K, D, E, N, qc = _CASES[case]
    q, gf, rel, p = _case(3 + K * D + E + N, 2, N, K, D, E)
    ref = _jax_fwd(q, gf, rel, p, K, jnp.bfloat16)
    tp = _port_params(p, D, E)
    rb = {n: {leaf: t_attn.round_bf16(v) if leaf == 'kernel' else v for leaf, v in d.items()}
          for n, d in tp.items()}
    gfb = t_attn.round_bf16(_t(gf))
    out = t_attn.attn_fwd_rows_plain(_t(q), _t(rel), gfb, rb, False, qc=qc,
                                     compute_dtype=torch.bfloat16)
    f32 = t_attn.attn_fwd_rows_plain(_t(q), _t(rel), _t(gf), tp, False, qc=qc)
    assert _rel_l2(out, ref) <= FTOL < _rel_l2(f32, ref), (_rel_l2(out, ref),
                                                          _rel_l2(f32, ref))
    plain = t_sattn.sattn_plain(_t(q), gfb, _t(rel), rb, torch.bfloat16)
    assert _rel_l2(out, plain) <= FTOL


@pytest.mark.parametrize('N', [129, 130, 131])
@pytest.mark.parametrize('K', [1, 17])
def test_interp_g_bwd_plain_matches_jax_at_ragged_groups(N, K):
    '''interp_g_bwd_plain against jax.vjp of fused_knn_interp(gathered=) (the
    _interp_g_bwd kernel) at N = 1, 2, 3 mod 4 (the CUDA kernel's runs start
    at another 16-byte offset in each plane, its last group of queries is
    short) and E + 3 = 27, at k = 1 and k = K_ext (no zero rows); the zero rows and position columns
    exact. The CUDA kernel equals this plain version bit for bit
    (tests/test_torch_cuda.py).'''
    rng = np.random.RandomState(70 + N + K)
    B, M, E, k_ext = 2, 90, 24, 17
    q, pos2 = _cloud(rng, B, N, 3), _cloud(rng, B, M, 3)
    feats = rng.randn(B, M, E).astype(np.float32)
    jknn = j_pa.knn_extract(jnp.asarray(q), jnp.asarray(pos2), k_ext)
    tknn = t_attn.knn_extract(_t(q), _t(pos2), k_ext)
    jg = j_pa.knn_gather_rows(jnp.asarray(pos2), jnp.asarray(feats), jknn, k_ext)
    _, vjp = jax.vjp(lambda gg: j_pa.fused_knn_interp(
        jnp.asarray(q), jnp.asarray(pos2), jnp.asarray(feats), K, knn=jknn, gathered=gg), jg)
    go = rng.randn(B, N, E).astype(np.float32)
    ref = np.asarray(vjp(jnp.asarray(go))[0])[:, :, :N]
    dg = t_attn.interp_g_bwd_plain(tknn[1], _t(go), K, k_ext, E, 1e-4).numpy()
    assert dg.shape == (B, k_ext, N, E + 3)
    np.testing.assert_allclose(dg, ref, atol=GATOL, rtol=GRTOL)
    np.testing.assert_array_equal(dg[:, K:], ref[:, K:])
    np.testing.assert_array_equal(dg[..., E:], ref[..., E:])
    assert not dg[:, K:].any() and not dg[..., E:].any()
