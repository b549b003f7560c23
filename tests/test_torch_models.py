'''
The port's model modules held against the JAX package's flax modules on the
CPU: random flax init -> numpy -> checkpoint.from_jax_params ->
load_state_dict(strict=True), then the same numpy inputs through both.

Tolerance atol=3e-5, rtol=1e-4 (the JAX tests' f32 CPU tolerance): the kNN
graphs and FPS picks are exact, the remaining difference is summation order
in the dense layers and softmax.
'''

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# Six test workers share eight cores: keep PyTorch's CPU pool small.
torch.set_num_threads(2)

from occlusions4d_tpu.checkpoint import export_torch_state_dict
from occlusions4d_tpu.models.encoder import PointEncoder as JEncoder
from occlusions4d_tpu.models.fused import fused_field_apply as j_fused_field_apply
from occlusions4d_tpu.models.implicit import LocalImplicitField as JField
from occlusions4d_torch.checkpoint import from_jax_params
from occlusions4d_torch.models import (LocalImplicitField, PointEncoder,
                                       fused_field_apply, positional_encode)

ATOL, RTOL = 3e-5, 1e-4

# Narrow gv1 shape: the gv1 pyramid rule (factor 3, 3 down blocks, K 16/12)
# at 600 points and 8 channels.
_ENC_GV1_NARROW = dict(n_input=600, n_output=600, d_in=8, d_out=1, d_feat=8,
                       down_blocks=3, up_blocks=3, transition_factor=3,
                       pt_num_neighbors=16, pt_norm_type='none', down_neighbors=12,
                       abstract_levels=1, global_dim=16, fps_random_start=False)
_ENC_LAYER_L2 = dict(_ENC_GV1_NARROW, n_input=300, n_output=300, down_blocks=2,
                     transition_factor=4, pt_num_neighbors=4, down_neighbors=4,
                     pt_norm_type='layer', abstract_levels=2)
_ENC_BATCH = dict(_ENC_LAYER_L2, pt_norm_type='batch', abstract_levels=1)
_DEC = dict(d_in=4, d_hidden=40, d_out=5, d_latent=40, n_blocks=6,
            pos_encoding_freqs=8, activation='relu', num_local_features=8,
            local_mode='attention', d_latent_local=24, cross_attn_neighbors=14,
            cross_attn_layers=2, cr_attn_type='cc')


@pytest.fixture
def rng():
    return np.random.RandomState(5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)  # writable copies.


def _encoder_pair(args, rng, n):
    pcl = rng.rand(1, n, 8).astype(np.float32) * 2 - 1
    jenc = JEncoder(fused_attention='off', **args)
    variables = _np_tree(jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(pcl)))
    if 'batch_stats' in variables:  # non-trivial running statistics.
        variables['batch_stats'] = jax.tree_util.tree_map(
            lambda a: (rng.rand(*a.shape).astype(np.float32) + 0.5),
            variables['batch_stats'])
    tenc = PointEncoder(**args)
    tenc.load_state_dict(from_jax_params(variables, tenc), strict=True)
    return pcl, jenc, variables, tenc.eval()


@pytest.mark.parametrize('args', [_ENC_GV1_NARROW, _ENC_LAYER_L2, _ENC_BATCH],
                         ids=['gv1_narrow', 'layer_levels2', 'batch'])
def test_encoder_matches_jax(rng, args):
    pcl, jenc, variables, tenc = _encoder_pair(args, rng, args['n_input'])
    ref_abs, ref_g, _ = jax.jit(jenc.apply)(variables, jnp.asarray(pcl))
    with torch.no_grad():
        out_abs, out_g = tenc(torch.tensor(pcl))
    assert out_abs.shape == ref_abs.shape
    np.testing.assert_array_equal(out_abs[..., :3].numpy(), np.asarray(ref_abs)[..., :3])
    np.testing.assert_allclose(out_abs.numpy(), np.asarray(ref_abs), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out_g.numpy(), np.asarray(ref_g), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('args', [_ENC_GV1_NARROW, _ENC_LAYER_L2, _ENC_BATCH],
                         ids=['gv1_narrow', 'layer_levels2', 'batch'])
def test_from_jax_params_keys_equal_export_torch_state_dict(rng, args):
    jenc = JEncoder(fused_attention='off', **args)
    pcl = jnp.asarray(rng.rand(1, args['n_input'], 8).astype(np.float32))
    variables = _np_tree(jax.jit(jenc.init)(jax.random.PRNGKey(1), pcl))
    tenc = PointEncoder(**args)
    ours = from_jax_params(variables, tenc)
    theirs = export_torch_state_dict(variables, net='encoder')
    assert list(sorted(ours)) == list(sorted(theirs))
    for key, val in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), val)
    # The tensors are copies, not views of the tree's buffers.
    leaf = variables['params']['pre_mlp_0']['kernel']
    leaf[...] += 1.0
    assert not np.array_equal(ours['pre_mlp.0.weight'].numpy(), leaf.T)


def _decoder_pair(rng, N=150, M=70, mask=False):
    E = _DEC['d_latent_local']
    q = rng.rand(1, N, 4).astype(np.float32) * 2 - 1
    abstract = rng.rand(1, M, 3 + E).astype(np.float32) * 2 - 1
    fg = rng.rand(1, _DEC['d_latent'] - E).astype(np.float32)
    jdec = JField(**_DEC)
    variables = _np_tree(jax.jit(jdec.init)(jax.random.PRNGKey(2), jnp.asarray(q[:, :16]),
                                            jnp.asarray(abstract), jnp.asarray(fg)))
    tdec = LocalImplicitField(**_DEC)
    tdec.load_state_dict(from_jax_params(variables, tdec), strict=True)
    return (q, abstract, fg), jdec, variables, tdec.eval()


def test_decoder_keys_equal_export_torch_state_dict(rng):
    _, _, variables, tdec = _decoder_pair(rng, N=20, M=30)
    assert sorted(from_jax_params(variables, tdec)) == \
        sorted(export_torch_state_dict(variables, net='decoder'))


def test_decoder_module_and_fused_match_jax(rng):
    (q, abstract, fg), jdec, variables, tdec = _decoder_pair(rng)
    ref, ref_pen = jax.jit(jdec.apply)(variables, q, abstract, fg)
    ref_f, _ = jax.jit(lambda v, a, b, c: j_fused_field_apply(jdec, v, a, b, c))(
        variables, q, abstract, fg)
    tq, ta, tg = torch.tensor(q), torch.tensor(abstract), torch.tensor(fg)
    with torch.no_grad():
        out, pen = tdec(tq, ta, tg)
        out_f, pen_f = fused_field_apply(tdec, tq, ta, tg)
    for got in (out, out_f):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_f), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(pen_f.numpy(), np.asarray(ref_pen), atol=ATOL, rtol=RTOL)


def test_decoder_masked_abstract_matches_jax(rng):
    (q, abstract, fg), jdec, variables, tdec = _decoder_pair(rng, N=90, M=60)
    mask = rng.rand(1, 60) > 0.3
    ref, _ = jax.jit(jdec.apply)(variables, q, abstract, fg, abstract_mask=mask)
    with torch.no_grad():
        out, _ = fused_field_apply(tdec, torch.tensor(q), torch.tensor(abstract),
                                   torch.tensor(fg), abstract_mask=torch.tensor(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_decoder_fused_at_shared_gather_size_on_cpu_matches_jax(rng):
    '''At M >= SHARED_GATHER_MIN_M the CPU still computes the fused function
    with the plain versions (on CUDA it raises until the shared-gather kernels
    are ported). The reference is JAX's fused path, whose shared-gather
    kernels run in interpret mode: both select neighbours by the same
    expanded distance, where near-ties among 1024 keys could otherwise split.'''
    from occlusions4d_torch.models.fused import SHARED_GATHER_MIN_M
    M = SHARED_GATHER_MIN_M
    (q, abstract, fg), jdec, variables, tdec = _decoder_pair(rng, N=40, M=M)
    ref, _ = jax.jit(lambda v, a, b, c: j_fused_field_apply(jdec, v, a, b, c))(
        variables, q, abstract, fg)
    with torch.no_grad():
        out, _ = fused_field_apply(tdec, torch.tensor(q), torch.tensor(abstract),
                                   torch.tensor(fg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_positional_encode_matches_jax(rng):
    from occlusions4d_tpu.models.implicit import positional_encode as j_pe
    p = rng.rand(50, 4).astype(np.float32) * 10 - 5
    np.testing.assert_allclose(positional_encode(torch.tensor(p), 0.1, 8).numpy(),
                               np.asarray(j_pe(jnp.asarray(p), 0.1, 8)),
                               atol=ATOL, rtol=RTOL)
