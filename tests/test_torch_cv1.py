'''
The cv1 slice of the port held against the JAX package on the CPU: the
decoder's shared-gather route, which both packages take when the abstract
cloud has SHARED_GATHER_MIN_M or more points (cv1: 2124). The port runs its
kernels' plain versions here; JAX runs its shared-gather Pallas kernels in
interpret mode, as its own tests run them. Inputs are made with numpy from a
seed and handed to both.

Tolerances: the gather is a copy and equals JAX's bit for bit; the gathered
interpolation equals the port's index route bit for bit (the same arithmetic
on the same rows); the rest within the JAX tests' f32 CPU tolerance atol
3e-5, rtol 1e-4 (summation order and fused multiply-adds between XLA and
PyTorch's CPU kernels). Route invariance of the port's decoder (threshold
10**9 against 1): the JAX test's own 1e-6 on the loss and 2e-5 / 2e-6 on
the gradients (the index route projects the key set before its gather,
premul, where the shared route projects each row after it).
'''

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# Six test workers share eight cores: keep PyTorch's CPU pool small.
torch.set_num_threads(2)

from occlusions4d_tpu.models import fused as j_fused
from occlusions4d_tpu.models.encoder import PointEncoder as JEncoder
from occlusions4d_tpu.models.implicit import LocalImplicitField as JField
from occlusions4d_tpu.ops import pallas_attention as j_pa
from occlusions4d_torch.checkpoint import from_jax_params
from occlusions4d_torch.models import LocalImplicitField, PointEncoder

t_attn = importlib.import_module('occlusions4d_torch.ops.attention')
t_fused = importlib.import_module('occlusions4d_torch.models.fused')

ATOL, RTOL = 3e-5, 1e-4


@pytest.fixture
def rng():
    return np.random.RandomState(31)


def _t(a):
    return torch.tensor(np.asarray(a))


def _cloud(rng, *shape):
    return rng.rand(*shape).astype(np.float32) * 2 - 1


def _knn_both(q, pos2, k, mask):
    jknn = j_pa.knn_extract(jnp.asarray(q), jnp.asarray(pos2), k, key_mask=jnp.asarray(mask))
    tknn = t_attn.knn_extract(_t(q), _t(pos2), k, key_mask=_t(mask))
    return jknn, tknn


def test_gather_rows_match_jax_exactly(rng):
    B, N, M, E, K = 2, 300, 200, 24, 6    # N is not a multiple of JAX's tile.
    q, pos2 = _cloud(rng, B, N, 3), _cloud(rng, B, M, 3)
    feats = rng.randn(B, M, E).astype(np.float32)
    mask = rng.rand(B, M) > 0.3
    jknn, tknn = _knn_both(q, pos2, K, mask)
    jg = np.asarray(j_pa.knn_gather_rows(jnp.asarray(pos2), jnp.asarray(feats), jknn, K))
    tg = t_attn.knn_gather_rows(_t(pos2), _t(feats), tknn, K)
    assert tuple(tg.shape) == (B, K, N, E + 3)
    np.testing.assert_array_equal(tg.numpy(), jg[:, :, :N])
    # Masked keys never enter the rows, and a prefix gather is a prefix.
    ki = tknn[0].numpy()
    assert all(mask[b][ki[b]].all() for b in range(B))
    np.testing.assert_array_equal(t_attn.knn_gather_rows(_t(pos2), _t(feats), tknn, 2).numpy(),
                                  tg[:, :2].numpy())


def test_gathered_interp_matches_jax_and_index_route(rng):
    B, N, M, E, K_EXT, K = 2, 150, 120, 24, 8, 5
    q, pos2 = _cloud(rng, B, N, 3), _cloud(rng, B, M, 3)
    feats = rng.randn(B, M, E).astype(np.float32)
    mask = rng.rand(B, M) > 0.2
    jknn, tknn = _knn_both(q, pos2, K_EXT, mask)
    jg = j_pa.knn_gather_rows(jnp.asarray(pos2), jnp.asarray(feats), jknn, K_EXT)
    ref = np.asarray(j_pa.fused_knn_interp(jnp.asarray(q), jnp.asarray(pos2),
                                           jnp.asarray(feats), K, key_mask=jnp.asarray(mask),
                                           knn=jknn, gathered=jg))
    tg = t_attn.knn_gather_rows(_t(pos2), _t(feats), tknn, K_EXT)
    out = t_attn.fused_knn_interp(_t(q), _t(pos2), _t(feats), K, knn=tknn, gathered=tg)
    idx = t_attn.fused_knn_interp(_t(q), _t(pos2), _t(feats), K, knn=tknn)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(out.numpy(), idx.numpy())


def _attn_params(rng, D, E, P=16):
    def w(*s):
        return (rng.randn(*s) * 0.1).astype(np.float32)
    return dict(to_k=dict(kernel=w(E, D)), to_v=dict(kernel=w(E, D)),
                pos_mlp_0=dict(kernel=w(3, P), bias=w(P)),
                pos_mlp_2=dict(kernel=w(P, D), bias=w(D)),
                attn_mlp_0=dict(kernel=w(D, 2 * D), bias=w(2 * D)),
                attn_mlp_2=dict(kernel=w(2 * D, D), bias=w(D)))


def _torch_params(p, grad=False):
    return {n: {k: _t(v).requires_grad_(grad) for k, v in d.items()} for n, d in p.items()}


@pytest.mark.parametrize('K', [1, 6, 14])
def test_gathered_attention_matches_jax_and_per_row_route(rng, K):
    '''The rows are gathered at 14 and each layer reads its k-prefix.'''
    B, N, M, D, E, K_EXT = 2, 130, 100, 32, 24, 14
    q, pos2 = _cloud(rng, B, N, 3), _cloud(rng, B, M, 3)
    feats = rng.randn(B, M, E).astype(np.float32)
    q_proj = rng.randn(B, N, D).astype(np.float32)
    mask = rng.rand(B, M) > 0.2
    p = _attn_params(rng, D, E)
    jknn, tknn = _knn_both(q, pos2, K_EXT, mask)
    jg = j_pa.knn_gather_rows(jnp.asarray(pos2), jnp.asarray(feats), jknn, K_EXT)
    ref = np.asarray(j_pa.fused_knn_vector_attention(
        jnp.asarray(q_proj), jnp.asarray(q), jnp.asarray(feats), jnp.asarray(pos2),
        jax.tree_util.tree_map(jnp.asarray, p), K, key_mask=jnp.asarray(mask), knn=jknn,
        gathered=jg))
    tp = _torch_params(p)
    tg = t_attn.knn_gather_rows(_t(pos2), _t(feats), tknn, K_EXT)
    out = t_attn.fused_knn_vector_attention(_t(q_proj), _t(q), _t(feats), _t(pos2), tp, K,
                                            knn=tknn, gathered=tg)
    per_row = t_attn.fused_knn_vector_attention(_t(q_proj), _t(q), _t(feats), _t(pos2), tp,
                                                K, knn=tknn, premul=False)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out.numpy(), per_row.numpy(), atol=ATOL, rtol=RTOL)


def test_gathered_composite_grads_match_jax(rng):
    '''Two attention layers and the interpolation over one shared gather (the
    decoder's shape): the port's CPU backward (autograd through the plain
    versions) against JAX's custom VJPs (scatter, attn_g and interp_g
    backward kernels in interpret mode). Tolerance atol 5e-6, rtol 2e-4, the
    JAX gradient tests' own.'''
    B, N, M, D, E, K_ATTN, K_INTERP = 1, 100, 80, 32, 24, 6, 4
    q, pos2 = _cloud(rng, B, N, 3), _cloud(rng, B, M, 3)
    feats = rng.randn(B, M, E).astype(np.float32)
    q_proj = rng.randn(B, N, D).astype(np.float32)
    mask = rng.rand(B, M) > 0.1
    p = _attn_params(rng, D, E)
    k_ext = max(K_ATTN, K_INTERP)

    def jloss(f, qp, pp):
        knn = j_pa.knn_extract(jnp.asarray(q), jnp.asarray(pos2), k_ext,
                               key_mask=jnp.asarray(mask))
        g = j_pa.knn_gather_rows(jnp.asarray(pos2), f, knn, k_ext)
        a = j_pa.fused_knn_vector_attention(qp, jnp.asarray(q), f, jnp.asarray(pos2), pp,
                                            K_ATTN, knn=knn, gathered=g)
        b = j_pa.fused_knn_vector_attention(a * 0.5 + qp, jnp.asarray(q), f,
                                            jnp.asarray(pos2), pp, K_ATTN, knn=knn,
                                            gathered=g)
        i = j_pa.fused_knn_interp(jnp.asarray(q), jnp.asarray(pos2), f, K_INTERP,
                                  knn=knn, gathered=g)
        return jnp.sum(jnp.sin(b)) + jnp.sum(i * i)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(feats), jnp.asarray(q_proj), jax.tree_util.tree_map(jnp.asarray, p))
    tf, tq = _t(feats).requires_grad_(True), _t(q_proj).requires_grad_(True)
    tp = _torch_params(p, grad=True)
    knn = t_attn.knn_extract(_t(q), _t(pos2), k_ext, key_mask=_t(mask))
    g = t_attn.knn_gather_rows(_t(pos2), tf, knn, k_ext)
    a = t_attn.fused_knn_vector_attention(tq, _t(q), tf, _t(pos2), tp, K_ATTN, knn=knn,
                                          gathered=g)
    b = t_attn.fused_knn_vector_attention(a * 0.5 + tq, _t(q), tf, _t(pos2), tp, K_ATTN,
                                          knn=knn, gathered=g)
    i = t_attn.fused_knn_interp(_t(q), _t(pos2), tf, K_INTERP, knn=knn, gathered=g)
    (torch.sin(b).sum() + (i * i).sum()).backward()
    GATOL, GRTOL = 5e-6, 2e-4
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jg[0]), atol=GATOL, rtol=GRTOL)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jg[1]), atol=GATOL, rtol=GRTOL)
    for n, d in tp.items():
        for leaf, v in d.items():
            np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg[2][n][leaf]),
                                       atol=GATOL, rtol=GRTOL, err_msg=f'{n}/{leaf}')


_DEC = dict(d_in=4, d_hidden=40, d_out=18, d_latent=40, n_blocks=4, pos_encoding_freqs=2,
            activation='relu', num_local_features=8, local_mode='attention',
            d_latent_local=24, cross_attn_neighbors=14, cross_attn_layers=2,
            cr_attn_type='cc')


def _spy_gather(monkeypatch):
    '''Count the decoder's calls of knn_gather_interp (the shared route's
    gather and interpolation).'''
    calls = []

    def spy(*args, **kw):
        calls.append(1)
        return t_attn.knn_gather_interp(*args, **kw)
    monkeypatch.setattr(t_fused, 'knn_gather_interp', spy)
    return calls


def _decoder_pair(rng, N, M):
    E = _DEC['d_latent_local']
    q = _cloud(rng, 1, N, 4)
    abstract = _cloud(rng, 1, M, 3 + E)
    fg = rng.rand(1, _DEC['d_latent'] - E).astype(np.float32)
    jdec = JField(**_DEC)
    variables = jax.tree_util.tree_map(np.array, jax.jit(jdec.init)(
        jax.random.PRNGKey(3), jnp.asarray(q[:, :16]), jnp.asarray(abstract),
        jnp.asarray(fg)))
    tdec = LocalImplicitField(**_DEC)
    tdec.load_state_dict(from_jax_params(variables, tdec), strict=True)
    return (q, abstract, fg), jdec, variables, tdec.eval()


def test_fused_decoder_shared_gather_matches_jax(rng, monkeypatch):
    '''Both packages' fused decoders with the threshold lowered to 1, so both
    take the shared-gather route at M = 64.'''
    (q, abstract, fg), jdec, variables, tdec = _decoder_pair(rng, 90, 64)
    monkeypatch.setattr(j_fused, 'SHARED_GATHER_MIN_M', 1)
    monkeypatch.setattr(t_fused, 'SHARED_GATHER_MIN_M', 1)
    ref, ref_pen = jax.jit(lambda v, a, b, c: j_fused.fused_field_apply(jdec, v, a, b, c))(
        variables, q, abstract, fg)
    calls = _spy_gather(monkeypatch)
    with torch.no_grad():
        out, pen = t_fused.fused_field_apply(tdec, _t(q), _t(abstract), _t(fg))
    assert len(calls) == 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(pen.numpy(), np.asarray(ref_pen), atol=ATOL, rtol=RTOL)


def test_fused_decoder_route_invariance_forward_and_grad(rng, monkeypatch):
    '''fused_field_apply gives the same output and CPU gradients (decoder
    weights and abstract features) on either route (threshold 10**9: index
    route; 1: shared gather), as tests/test_pallas_ops.py pins for JAX.'''
    (q, abstract, fg), _, _, tdec = _decoder_pair(rng, 120, 64)

    calls = _spy_gather(monkeypatch)

    def run(min_m):
        monkeypatch.setattr(t_fused, 'SHARED_GATHER_MIN_M', min_m)
        tdec.zero_grad()
        a = _t(abstract).requires_grad_(True)
        out, _ = t_fused.fused_field_apply(tdec, _t(q), a, _t(fg))
        loss = (out ** 2).sum()
        loss.backward()
        return loss.item(), [a.grad.clone()] + [p.grad.clone() for p in tdec.parameters()]

    l0, g0 = run(10 ** 9)
    assert not calls
    l1, g1 = run(1)
    assert len(calls) == 1
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    assert len(g0) == len(g1)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-5, atol=2e-6)


def test_cv1_shaped_inference_matches_jax(rng, monkeypatch):
    '''The slice end to end: a cv1-shaped small encoder and decoder (layer
    norm, abstract_levels 2, 13 semantic classes, 'rgb_nosigmoid') through
    InferenceEngine.encode / decode_all on the CPU, the threshold lowered so
    the decoder takes the shared-gather route, against the JAX engine on the
    same weights (its module path, precision 'highest').'''
    from occlusions4d_torch.evaluate import InferenceEngine
    from occlusions4d_tpu.evaluate.inference import InferenceEngine as JEngine
    enc_args = dict(n_input=300, n_output=300, d_in=8, d_out=1, d_feat=6, down_blocks=2,
                    up_blocks=2, transition_factor=4, pt_num_neighbors=4,
                    pt_norm_type='layer', down_neighbors=4, abstract_levels=2,
                    skip_connections=False, enable_decoder=False, output_featurized=True,
                    output_global_emb=True, global_dim=16, fps_random_start=False)
    E = 6 * 2 ** 2
    dec_args = dict(_DEC, d_latent_local=E, d_hidden=16 + E, d_latent=16 + E)
    pcl = _cloud(rng, 300, 8)
    queries = np.concatenate([_cloud(rng, 700, 3) * 1.2, np.zeros((700, 1), np.float32)], -1)
    jenc = JEncoder(fused_attention='off', **enc_args)
    jdec = JField(**dec_args)
    venc = jax.tree_util.tree_map(np.array, jax.jit(jenc.init)(jax.random.PRNGKey(0),
                                                               jnp.asarray(pcl[None])))
    abstract0, fg0, _ = jax.jit(jenc.apply)(venc, jnp.asarray(pcl[None]))
    vdec = jax.tree_util.tree_map(np.array, jax.jit(jdec.init)(
        jax.random.PRNGKey(1), jnp.asarray(queries[None, :16]), abstract0, fg0))
    M = abstract0.shape[1]
    assert M == 75 + 19                                 # both pyramid levels.
    tenc, tdec = PointEncoder(**enc_args), LocalImplicitField(**dec_args)
    tenc.load_state_dict(from_jax_params(venc, tenc), strict=True)
    tdec.load_state_dict(from_jax_params(vdec, tdec), strict=True)
    monkeypatch.setattr(t_fused, 'SHARED_GATHER_MIN_M', M)
    heads = ('rgb_nosigmoid', True, 13)
    jeng = JEngine(dict(encoder=jenc, decoder=jdec, params=dict(encoder=venc, decoder=vdec)),
                   *heads, implicit_batch_size=256, precision='highest')
    teng = InferenceEngine(dict(encoder=tenc.eval(), decoder=tdec.eval(),
                                device=torch.device('cpu')), *heads,
                           implicit_batch_size=256)
    j_abs, j_fg = jeng.encode(pcl)
    ref = np.asarray(jeng.decode_all(queries, j_abs, j_fg))
    calls = _spy_gather(monkeypatch)
    t_abs, t_fg = teng.encode(pcl)
    out = teng.decode_all(queries, t_abs, t_fg)
    np.testing.assert_array_equal(t_abs[..., :3].numpy(), np.asarray(j_abs)[..., :3])
    np.testing.assert_allclose(t_abs.numpy(), np.asarray(j_abs), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_fg.numpy(), np.asarray(j_fg), atol=ATOL, rtol=RTOL)
    assert out.shape == ref.shape == (700, 18) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    assert len(calls) == 3                              # one per 256-query chunk.
