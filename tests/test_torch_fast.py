'''
The bf16 compute mode of the port (compute_dtype=torch.bfloat16, the
engine's precision='fast') held against the JAX package's
compute_dtype=jnp.bfloat16 on the CPU. The port runs its kernels' plain
versions in bf16 here; JAX runs its Pallas kernels in interpret mode, as its
own tests run them. Inputs and weights are made with numpy from a seed and
handed to both.

Tolerances: the bf16 gather equals JAX's bit for bit (a rounding copy); the
interpolation within rtol 1e-5, atol 1e-6 (exact bf16 products, f32 sums in
another order); the attention within relative L2 2e-4 and a largest error of
5e-3 of max |out| (an f32 intermediate that differs by one ulp between the
two summation orders may round to a neighbouring bf16 operand), and, as
JAX's own test of its bf16 mode, within 3e-2 of the f32 output; the whole
decoder within relative L2 2e-3 (the attention's differences through the
backbone).
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
from occlusions4d_tpu.models.implicit import LocalImplicitField as JField
from occlusions4d_tpu.ops import pallas_attention as j_pa
from occlusions4d_torch.checkpoint import from_jax_params
from occlusions4d_torch.models import LocalImplicitField

t_attn = importlib.import_module('occlusions4d_torch.ops.attention')
t_fused = importlib.import_module('occlusions4d_torch.models.fused')

BF = torch.bfloat16


@pytest.fixture
def rng():
    return np.random.RandomState(47)


def _t(a):
    return torch.tensor(np.asarray(a))


def _cloud(rng, *shape):
    return rng.rand(*shape).astype(np.float32) * 2 - 1


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_attn_close(out, ref):
    assert _rel_l2(out, ref) <= 2e-4, _rel_l2(out, ref)
    assert np.abs(out - ref).max() <= 5e-3 * np.abs(ref).max()


def _knn_both(q, pos2, k, mask):
    jknn = j_pa.knn_extract(jnp.asarray(q), jnp.asarray(pos2), k, key_mask=jnp.asarray(mask))
    tknn = t_attn.knn_extract(_t(q), _t(pos2), k, key_mask=_t(mask))
    return jknn, tknn


def _attn_params(rng, D, E, P=16):
    def w(*s):
        return (rng.randn(*s) * 0.2).astype(np.float32)
    return dict(to_k=dict(kernel=w(E, D)), to_v=dict(kernel=w(E, D)),
                pos_mlp_0=dict(kernel=w(3, P), bias=w(P)),
                pos_mlp_2=dict(kernel=w(P, D), bias=w(D)),
                attn_mlp_0=dict(kernel=w(D, 2 * D), bias=w(2 * D)),
                attn_mlp_2=dict(kernel=w(2 * D, D), bias=w(D)))


def _torch_params(p):
    return {n: {k: _t(v) for k, v in d.items()} for n, d in p.items()}


def test_round_bf16_is_round_to_nearest_even():
    x = np.array([1.0, 1 + 2 ** -8, 1 + 3 * 2 ** -8, -2.5 - 2 ** -7, 3.0e38, 1e-40],
                 np.float32)
    ref = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(t_attn.round_bf16(_t(x)).numpy(), ref)


def test_bf16_gather_matches_jax_exactly(rng):
    B, N, M, E, K = 2, 300, 200, 24, 6
    q, pos2 = _cloud(rng, B, N, 3), _cloud(rng, B, M, 3)
    feats = rng.randn(B, M, E).astype(np.float32)
    mask = rng.rand(B, M) > 0.3
    jknn, tknn = _knn_both(q, pos2, K, mask)
    jg = np.asarray(j_pa.knn_gather_rows(jnp.asarray(pos2), jnp.asarray(feats), jknn, K,
                                         compute_dtype=jnp.bfloat16))
    tg = t_attn.knn_gather_rows(_t(pos2), _t(feats), tknn, K, compute_dtype=BF)
    assert tg.dtype == torch.float32 and tuple(tg.shape) == (B, K, N, E + 3)
    np.testing.assert_array_equal(tg.numpy(), jg[:, :, :N])
    # The rows are the f32 gather's rounded to bf16, and the plain version's.
    f32 = t_attn.knn_gather_rows(_t(pos2), _t(feats), tknn, K)
    np.testing.assert_array_equal(tg.numpy(), t_attn.round_bf16(f32).numpy())
    fv = torch.cat([_t(feats), _t(pos2)], -1)
    np.testing.assert_array_equal(t_attn.gather_rows_plain(fv, tknn[0], K, BF).numpy(),
                                  tg.numpy())


@pytest.mark.parametrize('route', ['index', 'gathered'])
def test_bf16_interp_matches_jax(rng, route):
    B, N, M, E, K_EXT, K = 2, 150, 120, 24, 8, 5
    q, pos2 = _cloud(rng, B, N, 3), _cloud(rng, B, M, 3)
    feats = rng.randn(B, M, E).astype(np.float32)
    mask = rng.rand(B, M) > 0.2
    jknn, tknn = _knn_both(q, pos2, K_EXT, mask)
    jg = tg = None
    if route == 'gathered':
        jg = j_pa.knn_gather_rows(jnp.asarray(pos2), jnp.asarray(feats), jknn, K_EXT,
                                  compute_dtype=jnp.bfloat16)
        tg = t_attn.knn_gather_rows(_t(pos2), _t(feats), tknn, K_EXT, compute_dtype=BF)
    ref = np.asarray(j_pa.fused_knn_interp(jnp.asarray(q), jnp.asarray(pos2),
                                           jnp.asarray(feats), K, key_mask=jnp.asarray(mask),
                                           knn=jknn, gathered=jg,
                                           compute_dtype=jnp.bfloat16))
    out = t_attn.fused_knn_interp(_t(q), _t(pos2), _t(feats), K, knn=tknn, gathered=tg,
                                  compute_dtype=BF)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    f32 = t_attn.fused_knn_interp(_t(q), _t(pos2), _t(feats), K, knn=tknn)
    assert not np.array_equal(out.numpy(), f32.numpy())      # the mode took effect.


@pytest.mark.parametrize('mode', ['premul', 'per_row', 'gathered'])
def test_bf16_attention_matches_jax(rng, monkeypatch, mode):
    B, N, M, D, E, K_EXT, K = 2, 130, 100, 32, 24, 14, 10
    q, pos2 = _cloud(rng, B, N, 3), _cloud(rng, B, M, 3)
    feats = rng.randn(B, M, E).astype(np.float32)
    q_proj = rng.randn(B, N, D).astype(np.float32)
    mask = rng.rand(B, M) > 0.2
    p = _attn_params(rng, D, E)
    jknn, tknn = _knn_both(q, pos2, K_EXT, mask)
    jg = tg = None
    if mode == 'gathered':
        jg = j_pa.knn_gather_rows(jnp.asarray(pos2), jnp.asarray(feats), jknn, K_EXT,
                                  compute_dtype=jnp.bfloat16)
        tg = t_attn.knn_gather_rows(_t(pos2), _t(feats), tknn, K_EXT, compute_dtype=BF)
    monkeypatch.setattr(j_pa, 'FORCE_PREMUL', mode == 'premul')
    ref = np.asarray(j_pa.fused_knn_vector_attention(
        jnp.asarray(q_proj), jnp.asarray(q), jnp.asarray(feats), jnp.asarray(pos2),
        jax.tree_util.tree_map(jnp.asarray, p), K, key_mask=jnp.asarray(mask), knn=jknn,
        gathered=jg, compute_dtype=jnp.bfloat16))
    tp = _torch_params(p)
    args = (_t(q_proj), _t(q), _t(feats), _t(pos2), tp, K)
    kw = dict(knn=tknn, gathered=tg, premul=mode == 'premul')
    out = t_attn.fused_knn_vector_attention(*args, compute_dtype=BF, **kw).numpy()
    _assert_attn_close(out, ref)
    # JAX's own bound on its bf16 mode against f32 (test_pallas_ops.py), the
    # f32 mode reading f32 rows.
    if mode == 'gathered':
        kw['gathered'] = t_attn.knn_gather_rows(_t(pos2), _t(feats), tknn, K_EXT)
    f32 = t_attn.fused_knn_vector_attention(*args, **kw).numpy()
    assert np.abs(out - f32).max() / np.abs(f32).max() < 3e-2
    assert not np.array_equal(out, f32)


def test_bf16_plain_versions_match_their_operators(rng):
    '''attn_plain / attn_g_plain / interp_plain / interp_g_plain in bf16 on
    unrounded inputs are the operators' CPU results (the card's kernels are
    held against these plain versions).'''
    B, N, M, D, E, K = 1, 90, 70, 32, 24, 8
    q, pos2 = _t(_cloud(rng, B, N, 3)), _t(_cloud(rng, B, M, 3))
    feats = _t(rng.randn(B, M, E).astype(np.float32))
    q_proj = _t(rng.randn(B, N, D).astype(np.float32))
    tp = _torch_params(_attn_params(rng, D, E))
    ki, kd = t_attn.knn_extract(q, pos2, K)
    g = t_attn.knn_gather_rows(pos2, feats, (ki, kd), K)           # f32 rows.
    op = t_attn.fused_knn_vector_attention(q_proj, q, feats, pos2, tp, K, knn=(ki, kd),
                                           premul=False, compute_dtype=BF)
    np.testing.assert_array_equal(
        t_attn.attn_plain(q, q_proj, ki, pos2, feats, tp, K, False, BF).numpy(), op.numpy())
    np.testing.assert_array_equal(
        t_attn.attn_g_plain(q, q_proj, g, tp, K, BF).numpy(), op.numpy())
    i_op = t_attn.fused_knn_interp(q, pos2, feats, 5, knn=(ki, kd), compute_dtype=BF)
    np.testing.assert_array_equal(t_attn.interp_plain(ki, kd, feats, 5, 1e-4, BF).numpy(),
                                  i_op.numpy())
    np.testing.assert_array_equal(t_attn.interp_g_plain(kd, g, 5, 1e-4, BF).numpy(),
                                  i_op.numpy())


_DEC = dict(d_in=4, d_hidden=40, d_out=18, d_latent=40, n_blocks=4, pos_encoding_freqs=2,
            activation='relu', num_local_features=8, local_mode='attention',
            d_latent_local=24, cross_attn_neighbors=14, cross_attn_layers=2,
            cr_attn_type='cc')


def _decoder_pair(rng, N, M):
    E = _DEC['d_latent_local']
    q = _cloud(rng, 1, N, 4)
    abstract = _cloud(rng, 1, M, 3 + E)
    fg = rng.rand(1, _DEC['d_latent'] - E).astype(np.float32)
    jdec = JField(**_DEC)
    variables = jax.tree_util.tree_map(np.array, jax.jit(jdec.init)(
        jax.random.PRNGKey(5), jnp.asarray(q[:, :16]), jnp.asarray(abstract),
        jnp.asarray(fg)))
    tdec = LocalImplicitField(**_DEC)
    tdec.load_state_dict(from_jax_params(variables, tdec), strict=True)
    return (q, abstract, fg), jdec, variables, tdec.eval()


@pytest.mark.parametrize('route', ['index', 'shared_gather'])
def test_bf16_fused_decoder_matches_jax(rng, monkeypatch, route):
    '''fused_field_apply(compute_dtype=bf16) against JAX's on the same
    weights; the shared-gather route with the threshold lowered in both
    packages, as tests/test_torch_cv1.py does.'''
    (q, abstract, fg), jdec, variables, tdec = _decoder_pair(rng, 110, 64)
    if route == 'shared_gather':
        monkeypatch.setattr(j_fused, 'SHARED_GATHER_MIN_M', 1)
        monkeypatch.setattr(t_fused, 'SHARED_GATHER_MIN_M', 1)
    ref, ref_pen = jax.jit(lambda v, a, b, c: j_fused.fused_field_apply(
        jdec, v, a, b, c, compute_dtype=jnp.bfloat16))(variables, q, abstract, fg)
    calls = []
    real = t_attn.knn_gather_interp

    def spy(*args, **kw):
        calls.append(kw.get('compute_dtype'))
        return real(*args, **kw)
    monkeypatch.setattr(t_fused, 'knn_gather_interp', spy)
    with torch.no_grad():
        out, pen = t_fused.fused_field_apply(tdec, _t(q), _t(abstract), _t(fg),
                                             compute_dtype=BF)
        f32, _ = t_fused.fused_field_apply(tdec, _t(q), _t(abstract), _t(fg))
    assert calls == ([BF, torch.float32] if route == 'shared_gather' else [])
    assert _rel_l2(out.numpy(), ref) <= 2e-3, _rel_l2(out.numpy(), ref)
    assert _rel_l2(pen.numpy(), ref_pen) <= 2e-3
    assert not np.array_equal(out.numpy(), f32.numpy())


def _engines(supported):
    '''The port's and JAX's engines over one small decoder (outside the
    fused path when not supported: local_mode 'feature').'''
    from occlusions4d_torch.evaluate import InferenceEngine
    from occlusions4d_tpu.evaluate.inference import InferenceEngine as JEngine
    dec = dict(_DEC) if supported else dict(_DEC, local_mode='feature')
    jdec, tdec = JField(**dec), LocalImplicitField(**dec)
    assert t_fused.supports_fused(tdec) == j_fused.supports_fused(jdec) == supported

    def pair(**kw):
        j = JEngine(dict(encoder=None, decoder=jdec, params={}), 'rgb_nosigmoid', True, 13,
                    implicit_batch_size=256, **kw)
        t = InferenceEngine(dict(encoder=None, decoder=tdec, device=torch.device('cpu')),
                            'rgb_nosigmoid', True, 13, implicit_batch_size=256, **kw)
        return j.precision, t.precision
    return pair


@pytest.mark.parametrize('supported', [True, False])
def test_engine_precision_resolution_matches_jax(supported):
    pair = _engines(supported)
    for kw in (dict(), dict(precision='auto'), dict(precision='fast'),
               dict(precision='f32'), dict(precision='highest'),
               dict(fused_decode=True), dict(fused_decode=False),
               dict(precision='highest', fused_decode=True)):
        j, t = pair(**kw)
        assert t == j, (kw, t, j)
    assert pair(precision='fast') == (('fast',) * 2 if supported else ('f32',) * 2)
    assert pair() == ('f32', 'f32')               # 'auto' off a TPU.


def test_engine_fast_decodes_in_bf16(rng):
    '''The CPU engine in 'fast' decodes through fused_field_apply in bf16.'''
    from occlusions4d_torch.evaluate import InferenceEngine
    (q, abstract, fg), _, _, tdec = _decoder_pair(rng, 100, 40)

    def decode(**kw):
        eng = InferenceEngine(dict(encoder=None, decoder=tdec, device=torch.device('cpu')),
                              'rgb_nosigmoid', True, 13, implicit_batch_size=64, **kw)
        return eng.decode_all(q[0], _t(abstract), _t(fg))
    fast = decode(precision='fast')
    with torch.no_grad():
        ref, _ = t_fused.fused_field_apply(tdec, _t(q), _t(abstract), _t(fg),
                                           compute_dtype=BF)
    assert fast.shape == (100, 18) and np.isfinite(fast).all()
    np.testing.assert_allclose(fast[:, 0], torch.sigmoid(ref[0, :, 0]).numpy(), rtol=1e-6,
                               atol=1e-7)
    assert not np.array_equal(fast, decode(precision='f32'))


def test_bf16_with_grad_raises(rng):
    '''A bf16 call whose input requires grad has the bf16 backward (held
    against JAX in tests/test_torch_fast_train.py): each operator's gradient
    is its plain bf16 backward's, not an f32 one paired with a bf16 forward;
    a compute dtype other than f32 and bf16 raises.'''
    B, N, M, D, E, K = 1, 40, 30, 16, 8, 4
    q, pos2 = _t(_cloud(rng, B, N, 3)), _t(_cloud(rng, B, M, 3))
    feats = _t(rng.randn(B, M, E).astype(np.float32)).requires_grad_(True)
    q_proj = _t(rng.randn(B, N, D).astype(np.float32)).requires_grad_(True)
    tp = _torch_params(_attn_params(rng, D, E))
    knn = t_attn.knn_extract(q, pos2, K)
    go_i = _t(rng.randn(B, N, E).astype(np.float32))
    t_attn.fused_knn_interp(q, pos2, feats, K, knn=knn, compute_dtype=BF).backward(go_i)
    np.testing.assert_array_equal(
        feats.grad.numpy(), t_attn.interp_bwd_plain(knn[0], knn[1], go_i, M, K, 1e-4,
                                                    BF).numpy())
    assert not np.array_equal(feats.grad.numpy(), t_attn.interp_bwd_plain(
        knn[0], knn[1], go_i, M, K, 1e-4).numpy())
    go_a = _t(rng.randn(B, N, D).astype(np.float32))
    t_attn.fused_knn_vector_attention(q_proj, q, feats.detach(), pos2, tp, K, knn=knn,
                                      premul=False, compute_dtype=BF).backward(go_a)
    ref = t_attn.attn_bwd_plain(q, q_proj.detach(), knn[0], pos2, feats.detach(), tp, K,
                                False, go_a, BF)[0]
    np.testing.assert_array_equal(q_proj.grad.numpy(), ref.numpy())
    for fn in (lambda: t_attn.fused_knn_interp(q, pos2, feats, K, knn=knn,
                                               compute_dtype=torch.float16),
               lambda: t_attn.fused_knn_vector_attention(q_proj, q, feats, pos2, tp, K,
                                                         knn=knn,
                                                         compute_dtype=torch.float16)):
        with pytest.raises(ValueError):
            fn()
