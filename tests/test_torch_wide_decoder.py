'''
Decoders wider than the attention forward kernel's 416-column block (csrc/
attn.cu runs them in column blocks on the card): D = global_size +
pt_feat_dim * 2^up_down_blocks reaches 448 with the JAX CLI's --pt_feat_dim
40 (E 320) and 544 with --global_size 256 (E 288). The port's fused decoder
(plain versions here, the path the card is held to) against the JAX
package's fused decoder on the CPU (its Pallas kernels in interpret mode,
its custom VJPs for the gradients). Inputs and weights are made with numpy
and JAX from a seed and handed to both.

Tolerances: the output within tests/test_torch_cv1.py's f32 CPU tolerance
atol 3e-5, rtol 1e-4; the gradients within its composite-gradient
tolerance atol 5e-6, rtol 2e-4 (summation order and fused multiply-adds
between XLA and PyTorch's CPU kernels).
'''

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# Six test workers share eight cores: keep PyTorch's CPU pool small.
torch.set_num_threads(2)

from occlusions4d_tpu.models import fused as j_fused
from occlusions4d_tpu.models.implicit import LocalImplicitField as JField
from occlusions4d_torch.checkpoint import from_jax_params
from occlusions4d_torch.models import LocalImplicitField
from occlusions4d_torch.models import fused as t_fused

ATOL, RTOL = 3e-5, 1e-4
GATOL, GRTOL = 5e-6, 2e-4


def _dec(D, E):
    return dict(d_in=4, d_hidden=D, d_out=5, d_latent=D, n_blocks=2, pos_encoding_freqs=0,
                activation='relu', num_local_features=8, local_mode='attention',
                d_latent_local=E, cross_attn_neighbors=14, cross_attn_layers=2,
                cr_attn_type='cc')


@pytest.mark.parametrize('dims', [(448, 320), (544, 288)])
def test_wide_fused_decoder_matches_jax_forward_and_grads(dims):
    '''fused_field_apply at D 448 / E 320 and D 544 / E 288 (24 queries, 40
    abstract points, 5 of them masked): the output and the gradients of
    sum(out^2) with respect to the abstract features and every decoder
    weight equal JAX's.'''
    D, E = dims
    cfg = _dec(D, E)
    rng = np.random.RandomState(D)
    q = (rng.rand(1, 24, 4) * 2 - 1).astype(np.float32)
    abstract = (rng.rand(1, 40, 3 + E) * 2 - 1).astype(np.float32)
    fg = rng.rand(1, D - E).astype(np.float32)
    mask = np.ones((1, 40), bool)
    mask[0, rng.choice(40, 5, replace=False)] = False
    jdec = JField(**cfg)
    variables = jax.tree_util.tree_map(np.array, jax.jit(jdec.init)(
        jax.random.PRNGKey(5), jnp.asarray(q[:, :8]), jnp.asarray(abstract),
        jnp.asarray(fg)))

    def jloss(v, a):
        out, _ = j_fused.fused_field_apply(jdec, v, jnp.asarray(q), a, jnp.asarray(fg),
                                           jnp.asarray(mask))
        return jnp.sum(out * out), out

    (_, jout), (jgv, jga) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        variables, jnp.asarray(abstract))
    tdec = LocalImplicitField(**cfg)
    tdec.load_state_dict(from_jax_params(variables, tdec), strict=True)
    a = torch.tensor(abstract).requires_grad_(True)
    out, _ = t_fused.fused_field_apply(tdec, torch.tensor(q), a, torch.tensor(fg),
                                       torch.tensor(mask))
    (out * out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jga), atol=GATOL, rtol=GRTOL)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgv), tdec)
    for name, p in tdec.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=GATOL, rtol=GRTOL,
                                   err_msg=name)
