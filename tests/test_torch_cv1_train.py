'''
The cv1 train slice of the port held against the JAX package on the CPU: the
backward of the decoder's shared-gather route (the gather's scatter, the
gathered interpolation's and attention's row cotangents), which both packages
take when the abstract cloud has SHARED_GATHER_MIN_M or more points (cv1:
2124). The port runs its kernels' plain backward versions here; JAX runs its
_scatter, _interp_g_bwd and _attn_g_bwd Pallas kernels in interpret mode
through their custom VJPs, as its own tests run them. Inputs are made with
numpy from a seed and handed to both.

Tolerances, each with its reason:
  * the plain backward functions atol 5e-6, rtol 2e-4, the JAX gradient
    tests' own (summation order and fused multiply-adds between XLA and
    PyTorch's CPU kernels); the zero rows past each consumer's k and the
    zero position columns exact;
  * the cv1-shaped lockstep: first-step gradients atol 1e-5, rtol 5e-4 (the
    JAX package's fused-vs-module gradient tolerance,
    tests/test_pallas_ops.py:245-283), losses rtol 2e-4 / atol 2e-5 and
    whole-model parameter deltas within 5e-4 of JAX's (the reference-parity
    lockstep's measure), as tests/test_torch_train.py holds the gv1 step.
'''

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# Six test workers share eight cores: keep PyTorch's CPU pool small.
torch.set_num_threads(2)

from occlusions4d_tpu.config import TrainConfig as JTrainConfig
from occlusions4d_tpu.models import fused as j_fused
from occlusions4d_tpu.models.encoder import PointEncoder as JEncoder
from occlusions4d_tpu.models.implicit import LocalImplicitField as JField
from occlusions4d_tpu.ops import pallas_attention as j_pa
from occlusions4d_tpu.pipeline import PipelineConfig as JPipelineConfig
from occlusions4d_tpu.pipeline import TrainPipeline as JTrainPipeline
from occlusions4d_tpu.sampler import SamplerConfig as JSamplerConfig
from occlusions4d_tpu.train import build_optimizer as j_build_optimizer
from occlusions4d_tpu.train import make_train_step as j_make_train_step
from occlusions4d_torch.checkpoint import from_jax_params
from occlusions4d_torch.config import TrainConfig
from occlusions4d_torch.models import LocalImplicitField, PointEncoder
from occlusions4d_torch.pipeline import PipelineConfig, TrainPipeline
from occlusions4d_torch.sampler import SamplerConfig
from occlusions4d_torch.train import Trainer, build_optimizer, make_train_step

from test_torch_cv1 import _attn_params, _cloud, _t
from test_torch_train import _JFixedSampler, _TFixedSampler

t_attn = importlib.import_module('occlusions4d_torch.ops.attention')
t_fused = importlib.import_module('occlusions4d_torch.models.fused')

GATOL, GRTOL = 5e-6, 2e-4


def _gathered_case(K):
    '''Shared inputs of one gathered decode: the rows gathered at k_ext > K
    (every consumer reads a K-prefix), from both packages' kNN.'''
    rng = np.random.RandomState(50 + K)
    B, N, M, D, E = 2, 130, 100, 32, 24
    k_ext = K + 3
    q, pos2 = _cloud(rng, B, N, 3), _cloud(rng, B, M, 3)
    feats = rng.randn(B, M, E).astype(np.float32)
    mask = rng.rand(B, M) > 0.2
    jknn = j_pa.knn_extract(jnp.asarray(q), jnp.asarray(pos2), k_ext,
                            key_mask=jnp.asarray(mask))
    tknn = t_attn.knn_extract(_t(q), _t(pos2), k_ext, key_mask=_t(mask))
    return rng, dict(B=B, N=N, M=M, D=D, E=E, k_ext=k_ext, q=q, pos2=pos2, feats=feats,
                     jknn=jknn, tknn=tknn)


def _pad_n(a, n_pad):
    '''(B, k, N, C) -> (B, k, n_pad, C) with zero rows: JAX pads the query axis.'''
    return np.pad(a, ((0, 0), (0, 0), (0, n_pad - a.shape[2]), (0, 0)))


def _assert_zero_rows_exact(port, ref, k, E):
    '''The rows past k and the position columns: zero in both, exactly.'''
    np.testing.assert_array_equal(port[:, k:], ref[:, k:])
    np.testing.assert_array_equal(port[..., E:], ref[..., E:])
    assert not port[:, k:].any() and not port[..., E:].any()


@pytest.mark.parametrize('K', [1, 6, 14])
def test_gather_bwd_plain_matches_jax_scatter(K):
    '''gather_bwd_plain against jax.vjp of knn_gather_rows (the _scatter
    kernel) on a seeded cotangent over every column, positions included.'''
    rng, c = _gathered_case(K)
    B, N, M, E, k_ext = c['B'], c['N'], c['M'], c['E'], c['k_ext']
    jg, vjp = jax.vjp(lambda p, f: j_pa.knn_gather_rows(p, f, c['jknn'], k_ext),
                      jnp.asarray(c['pos2']), jnp.asarray(c['feats']))
    dg = rng.randn(B, k_ext, N, E + 3).astype(np.float32)
    dpos, dfeats = vjp(jnp.asarray(_pad_n(dg, jg.shape[2])))
    dfv = t_attn.gather_bwd_plain(c['tknn'][0], _t(dg), M, k_ext).numpy()
    assert dfv.shape == (B, M, E + 3)
    np.testing.assert_allclose(dfv[..., :E], np.asarray(dfeats), atol=GATOL, rtol=GRTOL)
    np.testing.assert_allclose(dfv[..., E:], np.asarray(dpos), atol=GATOL, rtol=GRTOL)


@pytest.mark.parametrize('K', [1, 6, 14])
def test_interp_g_bwd_plain_matches_jax(K):
    '''interp_g_bwd_plain against jax.vjp of fused_knn_interp(gathered=) (the
    _interp_g_bwd kernel) in the gathered rows.'''
    rng, c = _gathered_case(K)
    B, N, E, k_ext = c['B'], c['N'], c['E'], c['k_ext']
    jg = j_pa.knn_gather_rows(jnp.asarray(c['pos2']), jnp.asarray(c['feats']), c['jknn'],
                              k_ext)
    _, vjp = jax.vjp(lambda gg: j_pa.fused_knn_interp(
        jnp.asarray(c['q']), jnp.asarray(c['pos2']), jnp.asarray(c['feats']), K,
        knn=c['jknn'], gathered=gg), jg)
    go = rng.randn(B, N, E).astype(np.float32)
    ref = np.asarray(vjp(jnp.asarray(go))[0])[:, :, :N]
    dg = t_attn.interp_g_bwd_plain(c['tknn'][1], _t(go), K, k_ext, E, 1e-4).numpy()
    assert dg.shape == (B, k_ext, N, E + 3)
    np.testing.assert_allclose(dg, ref, atol=GATOL, rtol=GRTOL)
    _assert_zero_rows_exact(dg, ref, K, E)


@pytest.mark.parametrize('K', [1, 6, 14])
def test_attn_g_bwd_plain_matches_jax(K):
    '''attn_g_bwd_plain against jax.vjp of fused_knn_vector_attention
    (gathered=) (the _attn_g_bwd kernel): d(q_proj), the rows' cotangent and
    every weight gradient.'''
    rng, c = _gathered_case(K)
    B, N, D, E, k_ext = c['B'], c['N'], c['D'], c['E'], c['k_ext']
    p = _attn_params(rng, D, E)
    q_proj = rng.randn(B, N, D).astype(np.float32)
    jg = j_pa.knn_gather_rows(jnp.asarray(c['pos2']), jnp.asarray(c['feats']), c['jknn'],
                              k_ext)
    _, vjp = jax.vjp(lambda qp, gg, pp: j_pa.fused_knn_vector_attention(
        qp, jnp.asarray(c['q']), jnp.asarray(c['feats']), jnp.asarray(c['pos2']), pp, K,
        knn=c['jknn'], gathered=gg), jnp.asarray(q_proj), jg,
        jax.tree_util.tree_map(jnp.asarray, p))
    go = rng.randn(B, N, D).astype(np.float32)
    jdq, jdg, jdw = vjp(jnp.asarray(go))
    tg = t_attn.knn_gather_rows(_t(c['pos2']), _t(c['feats']), c['tknn'], k_ext)
    tp = {n: {leaf: _t(v) for leaf, v in d.items()} for n, d in p.items()}
    dq, dg, dw = t_attn.attn_g_bwd_plain(_t(c['q']), _t(q_proj), tg, tp, K, _t(go))
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), atol=GATOL, rtol=GRTOL)
    ref = np.asarray(jdg)[:, :, :N]
    np.testing.assert_allclose(dg.numpy(), ref, atol=GATOL, rtol=GRTOL)
    _assert_zero_rows_exact(dg.numpy(), ref, K, E)
    assert set(dw) == {(n, leaf) for n, d in p.items() for leaf in d}
    for (n, leaf), v in dw.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jdw[n][leaf]), atol=GATOL,
                                   rtol=GRTOL, err_msg=f'{n}/{leaf}')


@pytest.mark.parametrize('K,KI', [(1, 1), (6, 9), (14, 8)])
def test_gather_interp_bwd_plain_matches_jax_shared_route(K, KI):
    '''The decoder route's backward of the gather and the interpolation
    against jax.vjp of the JAX shared route in the key features:
    knn_gather_rows, then fused_knn_interp
    (gathered=, its KI neighbours) and fused_knn_vector_attention(gathered=,
    K) over the same rows (the _scatter, _interp_g_bwd and _attn_g_bwd
    kernels in interpret mode). The port: gather_interp_bwd_plain of the
    attention's row cotangent and the interpolation's cotangent, and the
    same through autograd of knn_gather_interp; KI = k_ext (9) and KI <
    k_ext.'''
    rng, c = _gathered_case(K)
    B, N, M, D, E, k_ext = c['B'], c['N'], c['M'], c['D'], c['E'], c['k_ext']
    p = _attn_params(rng, D, E)
    q_proj = rng.randn(B, N, D).astype(np.float32)
    go_i = rng.randn(B, N, E).astype(np.float32)
    go_a = rng.randn(B, N, D).astype(np.float32)
    q, pos2 = jnp.asarray(c['q']), jnp.asarray(c['pos2'])
    jp = jax.tree_util.tree_map(jnp.asarray, p)

    def route(f):
        g = j_pa.knn_gather_rows(pos2, f, c['jknn'], k_ext)
        return (j_pa.fused_knn_interp(q, pos2, f, KI, knn=c['jknn'], gathered=g),
                j_pa.fused_knn_vector_attention(jnp.asarray(q_proj), q, f, pos2, jp, K,
                                                knn=c['jknn'], gathered=g))
    _, vjp = jax.vjp(route, jnp.asarray(c['feats']))
    ref = np.asarray(vjp((jnp.asarray(go_i), jnp.asarray(go_a)))[0])

    ki, kd = c['tknn']
    tp = {n: {leaf: _t(v) for leaf, v in d.items()} for n, d in p.items()}
    tg = t_attn.knn_gather_rows(_t(c['pos2']), _t(c['feats']), c['tknn'], k_ext)
    dg = t_attn.attn_g_bwd_plain(_t(c['q']), _t(q_proj), tg, tp, K, _t(go_a))[1]
    dfv = t_attn.gather_interp_bwd_plain(ki, kd, dg, _t(go_i), M, k_ext, KI, 1e-4)
    assert dfv.shape == (B, M, E + 3)
    np.testing.assert_allclose(dfv[..., :E].numpy(), ref, atol=GATOL, rtol=GRTOL)

    feats = _t(c['feats']).requires_grad_(True)
    g, fl = t_attn.knn_gather_interp(_t(c['pos2']), feats, c['tknn'], k_ext, KI)
    att = t_attn.fused_knn_vector_attention(_t(q_proj), _t(c['q']), feats, _t(c['pos2']),
                                            tp, K, knn=c['tknn'], gathered=g)
    ((fl * _t(go_i)).sum() + (att * _t(go_a)).sum()).backward()
    np.testing.assert_allclose(feats.grad.numpy(), ref, atol=GATOL, rtol=GRTOL)
    # The forward outputs are the separate operators' (same arithmetic).
    np.testing.assert_array_equal(g.detach().numpy(), tg.numpy())
    np.testing.assert_array_equal(
        fl.detach().numpy(),
        t_attn.fused_knn_interp(_t(c['q']), _t(c['pos2']), _t(c['feats']), KI,
                                knn=c['tknn'], gathered=tg).numpy())


# ---------------------------------------------------------------- lockstep --

_ENC = dict(n_input=256, n_output=256, d_in=8, d_out=1, d_feat=8, down_blocks=2,
            up_blocks=2, transition_factor=3, pt_num_neighbors=8, pt_norm_type='layer',
            down_neighbors=6, abstract_levels=2, skip_connections=False,
            enable_decoder=False, output_featurized=True, output_global_emb=True,
            global_dim=16, fps_random_start=False)
_DEC = dict(d_in=4, d_hidden=48, d_out=18, d_latent=48, n_blocks=3, pos_encoding_freqs=8,
            activation='relu', num_local_features=4, local_mode='attention',
            d_latent_local=32, cross_attn_neighbors=6, cross_attn_layers=2,
            cr_attn_type='cc')
# cv1's loss weights (bench.py:389-393) and heads: 13 classes, rgb_nosigmoid.
_PCFG = dict(color_mode='rgb_nosigmoid', semantic_classes=13, past_frames=2,
             future_frames=0, density_lw=1.0, color_lw=0.0, segmentation_lw=0.6,
             tracking_lw=0.0)


def _carla_supervision(T, n_q, seed=3):
    '''Fixed (queries, targets) per frame in the sampler's output layout:
    density, rgb (unavailable on CARLA: -1), track -1, segm in [-1, 13).'''
    rng = np.random.RandomState(seed)
    q = np.concatenate([(rng.rand(T, n_q, 3) * 4.0 - 2.0).astype(np.float32),
                        np.tile(np.arange(T, dtype=np.float32)[:, None, None],
                                (1, n_q, 1))], axis=-1)
    tgt = np.full((T, n_q, 6), -1.0, np.float32)
    tgt[..., 0] = (rng.rand(T, n_q) < 0.5).astype(np.float32)
    tgt[..., 5] = rng.randint(-1, 13, (T, n_q))
    return q, tgt


def _spy(monkeypatch, names):
    '''Count the calls of the given module functions of ops/attention.py.'''
    calls = {n: 0 for n in names}
    for n in names:
        fn = getattr(t_attn, n)

        def spy(*a, _fn=fn, _n=n, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(t_attn, n, spy)
    return calls


_BWD = ('gather_interp_bwd_plain', 'gather_bwd_plain', 'interp_g_bwd_plain',
        'attn_g_bwd_plain')


def test_cv1_train_step_lockstep_with_jax(monkeypatch):
    '''A cv1-shaped train step (layer norm, abstract_levels 2, 13 classes,
    segmentation_lw 0.6, colour and tracking weights 0, CARLA-style targets,
    fixed sampler) against JAX make_train_step with fused_decoder='on' over 3
    steps from one init, SHARED_GATHER_MIN_M lowered to 1 in both packages so
    both decoders take the shared-gather route and its backward (JAX: its
    _scatter / _attn_g_bwd / _interp_g_bwd kernels): the first step's
    gradients, every step's losses (loss_segm included) and parameters.'''
    monkeypatch.setattr(j_fused, 'SHARED_GATHER_MIN_M', 1)
    monkeypatch.setattr(t_fused, 'SHARED_GATHER_MIN_M', 1)
    rng = np.random.RandomState(3)
    pcl = (rng.rand(1, 256, 8) * 2.0 - 1.0).astype(np.float32)
    queries, targets = _carla_supervision(2, 96)
    jenc, jdec = JEncoder(**_ENC), JField(**_DEC)
    enc_vars = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(pcl))
    ab, fg, _ = jenc.apply(enc_vars, jnp.asarray(pcl))
    assert ab.shape[1] == 86 + 29                      # both pyramid levels.
    dec_vars = jax.jit(jdec.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 4)), ab, fg)
    jpipe = JTrainPipeline(jenc, jdec, JSamplerConfig(), JPipelineConfig(**_PCFG),
                           remat=True, fused_decoder='on', fused_decoder_dtype='f32')
    assert jpipe.fused_decoder
    jpipe.sampler = _JFixedSampler(queries, targets, 48)
    tenc, tdec = PointEncoder(**_ENC), LocalImplicitField(**_DEC)
    jparams = dict(encoder=enc_vars, decoder=dec_vars)
    tenc.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, enc_vars),
                                         tenc), strict=True)
    tdec.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, dec_vars),
                                         tdec), strict=True)
    tpipe = TrainPipeline(tenc.train(), tdec.train(), SamplerConfig(),
                          PipelineConfig(**_PCFG))
    tpipe.sampler = _TFixedSampler(queries, targets, 48)
    batch = dict(pcl_input=pcl, pcl_target=np.zeros((1, 2, 8, 11), np.float32),
                 pcl_target_valid=np.ones((1, 2, 8), bool),
                 valo_ids=np.zeros((1, 256), np.int32), num_valo_ids=np.zeros((1,), np.int32))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: _t(v) for k, v in batch.items()}
    cfg = dict(learn_rate=1e-3, num_epochs=20, lr_decay=0.5, gradient_clip=0.2)
    tx, _ = j_build_optimizer(JTrainConfig(**cfg, mixed_precision=False), 1000)
    calls = _spy(monkeypatch, _BWD)

    jg = jax.jit(jax.grad(lambda p: jpipe.loss(p, jbatch, jax.random.PRNGKey(0))[0]))(jparams)
    t_params = dict(tenc.named_parameters(), **{
        'dec.' + n: p for n, p in tdec.named_parameters()})
    loss, _ = tpipe.loss(tbatch, torch.Generator())
    tg = dict(zip(t_params, torch.autograd.grad(loss, list(t_params.values()))))
    # Two frames: one scatter each, with the interpolation's backward added
    # from its (B, N, E) cotangent (no dense row cotangent), and one
    # attention backward per frame and layer.
    assert calls == dict(gather_interp_bwd_plain=2, gather_bwd_plain=2,
                         interp_g_bwd_plain=0, attn_g_bwd_plain=4)
    ref = dict(from_jax_params(jax.tree_util.tree_map(np.asarray, jg['encoder']), tenc))
    ref.update({'dec.' + k: v for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, jg['decoder']), tdec).items()})
    for name, g in tg.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=1e-5, rtol=5e-4,
                                   err_msg=name)

    state = dict(params=jparams, opt_state=tx.init(jparams), step=jnp.zeros((), jnp.int32))
    jstep = j_make_train_step(jpipe, tx)
    tstep = make_train_step(tpipe, build_optimizer(TrainConfig(**cfg), 1000,
                                                   list(t_params.values())))
    init = {n: p.detach().clone() for n, p in t_params.items()}
    for i in range(3):
        state, jm = jstep(state, jbatch, jax.random.PRNGKey(i))
        tm = tstep(tbatch, torch.Generator())
        for k in ('total_loss', 'loss_dens', 'loss_segm', 'grad_norm'):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4, atol=2e-5,
                                       err_msg=f'step {i} {k}')
        assert float(tm['loss_segm']) > 0 and float(tm['loss_rgb']) == 0.0
        assert bool(tm['grads_finite']) and bool(tm['params_finite'])
        jp = jax.tree_util.tree_map(np.asarray, state['params'])
        ref = dict(from_jax_params(jp['encoder'], tenc))
        ref.update({'dec.' + k: v for k, v in from_jax_params(jp['decoder'], tdec).items()})
        dt = torch.cat([(t_params[n].detach() - init[n]).ravel() for n in t_params])
        dj = torch.cat([(ref[n] - init[n]).ravel() for n in t_params])
        rel = float((dt - dj).norm() / dt.norm())
        assert rel < 5e-4, (i, rel)


def test_cv1_trainer_steps_on_cpu_take_the_shared_route_backward(monkeypatch):
    '''Two Trainer(cv1-shaped config, 'carla', device='cpu') steps with the
    low_moving_ivalo_sembal sampler bias on a CARLA-layout batch (bench.py:
    57-82), the threshold lowered: finite losses (segmentation included), the
    parameters change, and the route's plain backward functions run (the
    scatter with the interpolation's backward added, and the
    attention's).'''
    monkeypatch.setattr(t_fused, 'SHARED_GATHER_MIN_M', 1)
    cfg = TrainConfig(n_points=256, pt_feat_dim=8, up_down_blocks=2, pt_num_neighbors=8,
                      down_neighbors=6, global_size=16, implicit_mlp_blocks=3,
                      cross_attn_layers=2, cross_attn_neighbors=6, cr_attn_type='cc',
                      num_cr_local_feats=4, color_mode='rgb_nosigmoid',
                      pt_norm_type='layer', abstract_levels=2, semantic_classes=13,
                      segmentation_lw=0.6, color_lw=0.0, tracking_lw=0.0,
                      cr_cube_bounds=2.0, cube_mode=4, num_cr_solid=48,
                      air_sampling_ratio=1.4, point_sample_bias='low_moving_ivalo_sembal',
                      past_frames=2, batch_size=2)
    tr = Trainer(cfg, 'carla', device='cpu').init_state(seed=0)
    rng = np.random.RandomState(1)
    B, T, M = 2, 2, 512
    tgt = np.zeros((B, T, M, 11), np.float32)
    # Inside the CARLA output cuboid of cube_mode 4 at bounds 2 (x 0..5,
    # y -2..2, z -1..0.8): the sampler needs 256 valid target points.
    tgt[..., :3] = rng.rand(B, T, M, 3) * [4.9, 3.8, 1.7] + [0.05, -1.9, -0.95]
    tgt[..., 4] = rng.randint(0, 50, (B, T, M))
    tgt[..., 5] = rng.randint(0, 23, (B, T, M))
    tgt[..., 6] = rng.randint(0, 4, (B, T, M))
    tgt[..., 7:10] = rng.rand(B, T, M, 3)
    batch = dict(pcl_input=(rng.rand(B, 256, 8) * 2 - 1).astype(np.float32),
                 pcl_target=tgt, pcl_target_valid=np.ones((B, T, M), bool),
                 valo_ids=np.tile(np.arange(256, dtype=np.int32), (B, 1)),
                 num_valo_ids=np.full((B,), 8, np.int32))
    calls = _spy(monkeypatch, _BWD)
    before = [p.detach().clone() for p in tr.optimizer.params]
    for _ in range(2):
        m = tr.step(batch)
        assert np.isfinite(float(m['total_loss'])) and float(m['loss_segm']) > 0
        assert bool(m['grads_finite']) and bool(m['params_finite']) and bool(m['sample_ok'])
    assert calls == dict(gather_interp_bwd_plain=4, gather_bwd_plain=4,
                         interp_g_bwd_plain=0, attn_g_bwd_plain=8)
    assert any(not torch.equal(p, q) for p, q in zip(tr.optimizer.params, before))


@pytest.mark.parametrize('case', ['uniform', 'skew', 'one_key'])
def test_scatter_counting_sort_index_and_chunked_sums(case):
    '''The scatter kernel's steps in plain PyTorch: its counting-sort inverse
    index over the gather's rows (inverse_index_plain, j-major, several sort
    tiles) equals the stable sort of scatter_index_plain with the rows past
    k skipped (KE > k) and a stable argsort; its chunked per-key sums
    (key_sums_plain, 64-row chunks, a long key cut across many) agree with
    gather_bwd_plain (scatter_add_) and index_add_: uniform keys, 80% of the
    rows on one key, and every row on one key.'''
    rng = np.random.RandomState(90)
    B, N, M, C, k, KE = 2, 300, 40, 11, 6, 9
    ki = rng.randint(0, M, size=(B, N, k + 2))
    if case == 'skew':
        ki[rng.rand(B, N, k + 2) < 0.8] = 3
    elif case == 'one_key':
        ki[:] = 5
    ki = _t(ki.astype(np.int32))
    dg = _t(rng.randn(B, KE, N, C).astype(np.float32))
    perm, offsets = t_attn.inverse_index_plain(ki, M, k, tile=256, jmajor=True)
    perm = perm.long()
    rows = perm + (perm // (k * N)) * ((KE - k) * N)
    p_rows, p_offsets = t_attn.scatter_index_plain(ki, M, k, KE)
    assert torch.equal(rows.int(), p_rows) and torch.equal(offsets, p_offsets)
    keys = (ki[..., :k].long() + M * torch.arange(B)[:, None, None]).transpose(1, 2)
    assert torch.equal(perm, torch.argsort(keys.reshape(-1), stable=True))
    entry_rows = dg[:, :k].reshape(B * k * N, C)
    sums = t_attn.key_sums_plain(entry_rows, perm, offsets).view(B, M, C)
    ref = t_attn.gather_bwd_plain(ki, dg, M, k)
    lib = torch.zeros((B * M, C)).index_add_(0, keys.reshape(-1), entry_rows).view(B, M, C)
    np.testing.assert_allclose(sums.numpy(), ref.numpy(), atol=GATOL, rtol=GRTOL)
    np.testing.assert_allclose(sums.numpy(), lib.numpy(), atol=GATOL, rtol=GRTOL)
    longest = int(torch.diff(offsets.long()).max())
    assert longest > (1000 if case != 'uniform' else 0)


def test_gather_interp_bwd_compositions_agree():
    '''The decoder route's backward of the gather and the gathered
    interpolation, in its three spellings on the CPU: the plain version
    (scatter + interpolation backward, what the route runs on the card),
    the scatter of dg plus interp_g_bwd's rows, and autograd through
    knn_gather_interp.'''
    rng, c = _gathered_case(14)
    B, N, M, E, k_ext = c['B'], c['N'], c['M'], c['E'], c['k_ext']
    ki, kd = c['tknn']
    dg = _t(rng.randn(B, k_ext, N, E + 3).astype(np.float32))
    go = _t(rng.randn(B, N, E).astype(np.float32))
    plain = t_attn.gather_interp_bwd_plain(ki, kd, dg, go, M, k_ext, 8, 1e-4)
    unfolded = t_attn.gather_bwd_plain(
        ki, dg + t_attn.interp_g_bwd_plain(kd, go, 8, k_ext, E, 1e-4), M, k_ext)
    feats = _t(c['feats']).requires_grad_(True)
    g, fl = t_attn.knn_gather_interp(_t(c['pos2']), feats, c['tknn'], k_ext, 8)
    (g * dg).sum().backward(retain_graph=True)
    fl.backward(go)
    np.testing.assert_allclose(plain.numpy(), unfolded.numpy(), atol=GATOL, rtol=GRTOL)
    np.testing.assert_allclose(feats.grad.numpy(), plain[..., :E].numpy(), atol=GATOL,
                               rtol=GRTOL)
