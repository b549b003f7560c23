'''
The encoder's fused self-attention in the port (ops/self_attention.py, the
VectorAttention / PointEncoder fused='on' path, the Trainer flag) held against
the JAX package on the CPU. The port runs the kernels' plain versions here;
JAX runs its _fwd_kernel / _bwd_kernel Pallas kernels in interpret mode
(fused_gathered_attention resolves interpret off a TPU), as its own tests run
them (tests/test_pallas_ops.py:363-410). Inputs are made with numpy from a
seed and handed to both; weights cross through checkpoint.from_jax_params.

Tolerances, each with its reason:
  * the plain forward 2e-6 (abs and rel), the JAX kernel-vs-chain tolerance
    (tests/test_pallas_ops.py:377-378): f32 summation order only;
  * the plain backward atol 5e-6, rtol 2e-4, the JAX gradient tests' own
    (tests/test_torch_cv1_train.py): weight gradients sum every row in
    another order; rel's gradient exactly zero in JAX and absent in the port;
  * modules and encoders: forward atol 3e-5 / rtol 1e-4 (the model tests'
    f32 tolerance), gradients atol 1e-4 / rtol 1e-4 (the JAX fused-vs-module
    gradient tolerance, tests/test_pallas_ops.py:384-394);
  * lockstep: first-step gradients atol 1e-5, rtol 5e-4, losses rtol 2e-4 /
    atol 2e-5 and parameter deltas within 5e-4 of JAX's, as
    tests/test_torch_train.py holds the gv1 step.
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
from occlusions4d_tpu.models.encoder import PointEncoder as JEncoder
from occlusions4d_tpu.models.implicit import LocalImplicitField as JField
from occlusions4d_tpu.models.layers import VectorAttention as JVectorAttention
from occlusions4d_tpu.ops.pallas_self_attention import fused_gathered_attention as j_fga
from occlusions4d_tpu.pipeline import PipelineConfig as JPipelineConfig
from occlusions4d_tpu.pipeline import TrainPipeline as JTrainPipeline
from occlusions4d_tpu.sampler import SamplerConfig as JSamplerConfig
from occlusions4d_tpu.train import build_optimizer as j_build_optimizer
from occlusions4d_tpu.train import make_train_step as j_make_train_step
from occlusions4d_torch.checkpoint import from_jax_params
from occlusions4d_torch.config import TrainConfig
from occlusions4d_torch.models import LocalImplicitField, PointEncoder, VectorAttention
from occlusions4d_torch.models.factory import build_models
from occlusions4d_torch.pipeline import PipelineConfig, TrainPipeline
from occlusions4d_torch.sampler import SamplerConfig
from occlusions4d_torch.train import Trainer, build_optimizer, make_train_step

from test_torch_train import _DEC, _ENC, _LWS, _JFixedSampler, _TFixedSampler, _supervision

t_sattn = importlib.import_module('occlusions4d_torch.ops.self_attention')
t_layers = importlib.import_module('occlusions4d_torch.models.layers')

GATOL, GRTOL = 5e-6, 2e-4


def _t(a):
    return torch.tensor(np.asarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)  # writable copies.


def _case(seed, B, N, K, D, E):
    '''Seeded operands of one fused block: q, gf, rel and the ten weights in
    the JAX layout (numpy).'''
    rng = np.random.RandomState(seed)

    def lin(i, o, bias=True):
        p = {'kernel': (rng.randn(i, o) / np.sqrt(i)).astype(np.float32)}
        if bias:
            p['bias'] = (rng.randn(o) * 0.1).astype(np.float32)
        return p
    params = {'to_k': lin(E, D, False), 'to_v': lin(E, D, False),
              'pos_mlp_0': lin(3, 32), 'pos_mlp_2': lin(32, D),
              'attn_mlp_0': lin(D, 2 * D), 'attn_mlp_2': lin(2 * D, D)}
    q = rng.randn(B, N, D).astype(np.float32)
    gf = rng.randn(B, N, K, E).astype(np.float32)
    rel = (rng.rand(B, N, K, 3) * 2 - 1).astype(np.float32)
    return q, gf, rel, params


def _torch_params(params):
    return {n: {leaf: _t(v) for leaf, v in d.items()} for n, d in params.items()}


_OPS_CASES = [(8, 24, 24), (16, 24, 24), (8, 24, 16), (16, 16, 40)]
_OPS_IDS = ['K8_E=D', 'K16_E=D', 'K8_E<D', 'K16_E>D']


@pytest.mark.parametrize('K,D,E', _OPS_CASES, ids=_OPS_IDS)
def test_sattn_plain_matches_jax_kernel(K, D, E):
    '''sattn_plain against JAX fused_gathered_attention (its _fwd_kernel in
    interpret mode): B 2, N 37 (not a multiple of the tile).'''
    q, gf, rel, p = _case(K + D + E, 2, 37, K, D, E)
    ref = np.asarray(j_fga(jnp.asarray(q), jnp.asarray(gf), jnp.asarray(rel),
                           jax.tree_util.tree_map(jnp.asarray, p), K))
    out = t_sattn.sattn_plain(_t(q), _t(gf), _t(rel), _torch_params(p)).numpy()
    assert out.shape == ref.shape == (2, 37, D)
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize('K,D,E', _OPS_CASES, ids=_OPS_IDS)
def test_sattn_bwd_plain_matches_jax_vjp(K, D, E):
    '''sattn_bwd_plain against jax.vjp of fused_gathered_attention (its
    _bwd_kernel in interpret mode): dq, dgf and the ten weight gradients;
    rel's cotangent is zero in JAX, and the port's operator gives rel none.'''
    q, gf, rel, p = _case(100 + K + D + E, 2, 37, K, D, E)
    go = np.random.RandomState(7).randn(2, 37, D).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c, pp: j_fga(a, b, c, pp, K), jnp.asarray(q),
                     jnp.asarray(gf), jnp.asarray(rel), jax.tree_util.tree_map(jnp.asarray, p))
    jdq, jdgf, jdrel, jdw = vjp(jnp.asarray(go))
    dq, dgf, dw = t_sattn.sattn_bwd_plain(_t(q), _t(gf), _t(rel), _torch_params(p), _t(go))
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), atol=GATOL, rtol=GRTOL)
    np.testing.assert_allclose(dgf.numpy(), np.asarray(jdgf), atol=GATOL, rtol=GRTOL)
    assert not np.asarray(jdrel).any()
    assert set(dw) == {(n, leaf) for n, d in p.items() for leaf in d} and len(dw) == 10
    for (n, leaf), v in dw.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jdw[n][leaf]), atol=GATOL,
                                   rtol=GRTOL, err_msg=f'{n}/{leaf}')

    # The autograd operator: its backward is the plain backward; rel gets none.
    tq, tgf = _t(q).requires_grad_(True), _t(gf).requires_grad_(True)
    trel = _t(rel).requires_grad_(True)
    tp = {n: {leaf: v.requires_grad_(True) for leaf, v in d.items()}
          for n, d in _torch_params(p).items()}
    out = t_sattn.fused_gathered_attention(tq, tgf, trel, tp, K)
    leaves = [tp[n][leaf] for n, leaf in dw]
    grads = torch.autograd.grad(out, [tq, tgf] + leaves, _t(go), retain_graph=True)
    assert torch.equal(grads[0], dq) and torch.equal(grads[1], dgf)
    for g, key in zip(grads[2:], dw):
        assert torch.equal(g, dw[key]), key
    assert torch.autograd.grad(out, [trel], _t(go), allow_unused=True) == (None,)


def _attention_pair(seed, D, K, N=41, B=2):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, N, D).astype(np.float32)
    pos = (rng.rand(B, N, 3) * 2 - 1).astype(np.float32)
    jmod = JVectorAttention(dim=D, num_neighbors=K, fused='on')
    v = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(seed), jnp.asarray(x),
                                    jnp.asarray(pos)))
    tmod = VectorAttention(D, num_neighbors=K, fused='on')
    tmod.load_state_dict(from_jax_params(v, tmod), strict=True)
    return x, pos, jmod, v, tmod


def _module_grads(tmod, x, pos):
    xx = _t(x).requires_grad_(True)
    out = tmod(xx, _t(pos))
    grads = torch.autograd.grad(torch.sin(out * 3.0).sum(), [xx] + list(tmod.parameters()))
    return out.detach(), grads


@pytest.mark.parametrize('K', [8, 16])
def test_vector_attention_fused_on_matches_jax_and_chain(monkeypatch, K):
    '''VectorAttention(fused='on') against the JAX module with fused='on'
    (its Pallas kernels in interpret mode) and against the port's own 'auto'
    chain: forward and the full gradient surface (input features and every
    weight; positions carry none).'''
    calls = []
    spy = t_layers.fused_gathered_attention
    monkeypatch.setattr(t_layers, 'fused_gathered_attention',
                        lambda *a, **k: calls.append(1) or spy(*a, **k))
    D = 24
    x, pos, jmod, v, tmod = _attention_pair(K, D, K)
    ref = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(x), jnp.asarray(pos)))

    def loss(vv, xx):
        return jnp.sum(jnp.sin(jmod.apply(vv, xx, jnp.asarray(pos)) * 3.0))
    jgv, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(v, jnp.asarray(x))
    out, grads = _module_grads(tmod, x, pos)
    assert calls == [1]
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), atol=1e-4, rtol=1e-4)
    jg = from_jax_params(_np_tree(jgv), tmod)
    for (name, _), g in zip(tmod.named_parameters(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), jg[name].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    tmod.fused = 'auto'
    out_c, grads_c = _module_grads(tmod, x, pos)
    assert calls == [1]
    np.testing.assert_allclose(out.numpy(), out_c.numpy(), atol=3e-5, rtol=1e-4)
    for a, b in zip(grads, grads_c):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('case', ['k_not_multiple_of_8', 'key_mask', 'cross_attention'])
def test_vector_attention_fused_on_falls_back_to_chain(monkeypatch, case):
    '''fused='on' takes the chain, as the JAX module does, for K % 8 != 0, a
    key mask, or cross attention; the result equals the 'auto' module's.'''
    calls = []
    monkeypatch.setattr(t_layers, 'fused_gathered_attention',
                        lambda *a, **k: calls.append(1))
    rng = np.random.RandomState(9)
    D, K = 16, 6 if case == 'k_not_multiple_of_8' else 8
    torch.manual_seed(0)
    on = VectorAttention(D, num_neighbors=K, fused='on')
    auto = VectorAttention(D, num_neighbors=K, fused='auto')
    auto.load_state_dict(on.state_dict())
    x, pos = _t(rng.rand(2, 40, D).astype(np.float32)), _t(rng.rand(2, 40, 3).astype(np.float32))
    kw = {}
    if case == 'key_mask':
        kw = dict(key_mask=_t(rng.rand(2, 40) > 0.2))
    elif case == 'cross_attention':
        kw = dict(x2=_t(rng.rand(2, 30, D).astype(np.float32)),
                  pos2=_t(rng.rand(2, 30, 3).astype(np.float32)))
    with torch.no_grad():
        assert torch.equal(on(x, pos, **kw), auto(x, pos, **kw))
    assert calls == []
    with pytest.raises(ValueError):
        VectorAttention(D, fused='yes')


_ENC_TINY = dict(n_input=300, n_output=300, d_in=8, d_out=1, d_feat=8, down_blocks=2,
                 up_blocks=2, transition_factor=3, pt_num_neighbors=8, pt_norm_type='none',
                 down_neighbors=6, abstract_levels=1, global_dim=16, fps_random_start=False)


@pytest.mark.parametrize('levels', [1, 2])
def test_encoder_fused_attention_on_matches_jax(monkeypatch, levels):
    '''PointEncoder(fused_attention='on') against the JAX encoder with
    fused_attention='on': the gv1 structure at tiny widths, K 8, one and two
    abstract levels; outputs and every encoder gradient of a seeded
    projection of both outputs.'''
    calls = []
    spy = t_layers.fused_gathered_attention
    monkeypatch.setattr(t_layers, 'fused_gathered_attention',
                        lambda *a, **k: calls.append(1) or spy(*a, **k))
    args = dict(_ENC_TINY, abstract_levels=levels)
    rng = np.random.RandomState(20 + levels)
    pcl = (rng.rand(1, 300, 8) * 2 - 1).astype(np.float32)
    jenc = JEncoder(fused_attention='on', **args)
    v = _np_tree(jax.jit(jenc.init)(jax.random.PRNGKey(levels), jnp.asarray(pcl)))
    ref_abs, ref_g, _ = jax.jit(jenc.apply)(v, jnp.asarray(pcl))
    w_abs = rng.randn(*ref_abs.shape).astype(np.float32)
    w_g = rng.randn(*ref_g.shape).astype(np.float32)

    def loss(vv):
        a, g, _ = jenc.apply(vv, jnp.asarray(pcl))
        return jnp.sum(a * w_abs) + jnp.sum(g * w_g)
    jg = from_jax_params(_np_tree(jax.jit(jax.grad(loss))(v)), PointEncoder(**args))

    tenc = PointEncoder(fused_attention='on', **args)
    tenc.load_state_dict(from_jax_params(v, tenc), strict=True)
    out_abs, out_g = tenc(_t(pcl))
    assert len(calls) == 3                      # the three PT blocks.
    np.testing.assert_array_equal(out_abs[..., :3].detach().numpy(),
                                  np.asarray(ref_abs)[..., :3])
    np.testing.assert_allclose(out_abs.detach().numpy(), np.asarray(ref_abs), atol=3e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(out_g.detach().numpy(), np.asarray(ref_g), atol=3e-5,
                               rtol=1e-4)
    t_loss = (out_abs * _t(w_abs)).sum() + (out_g * _t(w_g)).sum()
    names = [n for n, _ in tenc.named_parameters()]
    for name, g in zip(names, torch.autograd.grad(t_loss, list(tenc.parameters()))):
        np.testing.assert_allclose(g.numpy(), jg[name].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_fused_attention_is_a_runtime_choice_not_an_encoder_arg():
    '''build_models and Trainer forward fused_attention to the encoder's
    blocks without adding it to encoder_args, and Trainer.init_state keeps it
    when it rebuilds the modules.'''
    cfg = TrainConfig(n_points=256, pt_feat_dim=8, up_down_blocks=2, pt_num_neighbors=8,
                      down_neighbors=6, global_size=16, implicit_mlp_blocks=3,
                      cross_attn_layers=2, cross_attn_neighbors=6, cr_attn_type='cc',
                      num_cr_local_feats=4, num_cr_solid=48, past_frames=2, batch_size=2)
    enc, _, enc_args, _ = build_models(cfg, fused_attention='on')
    assert 'fused_attention' not in enc_args
    modes = {m.fused for m in enc.modules() if isinstance(m, VectorAttention)}
    assert modes == {'on'}
    default, _, _, _ = build_models(cfg)
    assert {m.fused for m in default.modules() if isinstance(m, VectorAttention)} == {'auto'}
    tr = Trainer(cfg, device='cpu', fused_attention='on').init_state(seed=0)
    assert {m.fused for m in tr.encoder.modules() if isinstance(m, VectorAttention)} == {'on'}
    assert 'fused_attention' not in tr.encoder_args


def test_train_step_lockstep_with_jax_fused_attention_on(monkeypatch):
    '''The port's train step with the encoder's fused self-attention (plain
    forward and backward of its kernels) against JAX make_train_step with
    fused_attention='on' in its encoder (its Pallas kernels in interpret
    mode), 3 steps from one init under a fixed sampler: the first step's
    gradients, every step's losses and the parameters after every step.'''
    calls = {'fwd': 0, 'bwd': 0}
    fwd, bwd = t_sattn.sattn_plain, t_sattn.sattn_bwd_plain
    monkeypatch.setattr(t_sattn, 'sattn_plain',
                        lambda *a: calls.__setitem__('fwd', calls['fwd'] + 1) or fwd(*a))
    monkeypatch.setattr(t_sattn, 'sattn_bwd_plain',
                        lambda *a: calls.__setitem__('bwd', calls['bwd'] + 1) or bwd(*a))
    rng = np.random.RandomState(3)
    pcl = (rng.rand(1, 256, 8) * 2.0 - 1.0).astype(np.float32)
    queries, targets = _supervision(2, 96, 13)
    jenc, jdec = JEncoder(fused_attention='on', **_ENC), JField(**_DEC)
    enc_vars = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(pcl))
    ab, fg, _ = jenc.apply(enc_vars, jnp.asarray(pcl))
    dec_vars = jax.jit(jdec.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 4)), ab, fg)
    pcfg = dict(color_mode='rgb_nosigmoid', semantic_classes=13, past_frames=2,
                future_frames=0, **_LWS)
    jpipe = JTrainPipeline(jenc, jdec, JSamplerConfig(), JPipelineConfig(**pcfg),
                           remat=True, fused_decoder='off')
    jpipe.sampler = _JFixedSampler(queries, targets, 48)
    tenc = PointEncoder(fused_attention='on', **_ENC)
    tdec = LocalImplicitField(**_DEC)
    jparams = dict(encoder=enc_vars, decoder=dec_vars)
    tenc.load_state_dict(from_jax_params(_np_tree(enc_vars), tenc), strict=True)
    tdec.load_state_dict(from_jax_params(_np_tree(dec_vars), tdec), strict=True)
    tpipe = TrainPipeline(tenc.train(), tdec.train(), SamplerConfig(), PipelineConfig(**pcfg))
    tpipe.sampler = _TFixedSampler(queries, targets, 48)
    batch = dict(pcl_input=pcl, pcl_target=np.zeros((1, 2, 8, 9), np.float32),
                 pcl_target_valid=np.ones((1, 2, 8), bool),
                 valo_ids=np.zeros((1, 4), np.int32), num_valo_ids=np.zeros((1,), np.int32))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: _t(v) for k, v in batch.items()}
    cfg = dict(learn_rate=1e-3, num_epochs=20, lr_decay=0.5, gradient_clip=0.2)
    tx, _ = j_build_optimizer(JTrainConfig(**cfg, mixed_precision=False), 1000)

    jg = jax.jit(jax.grad(lambda p: jpipe.loss(p, jbatch, jax.random.PRNGKey(0))[0]))(jparams)
    t_params = dict(tenc.named_parameters(), **{
        'dec.' + n: p for n, p in tdec.named_parameters()})
    loss, _ = tpipe.loss(tbatch, torch.Generator())
    tg = dict(zip(t_params, torch.autograd.grad(loss, list(t_params.values()))))
    assert calls == dict(fwd=3, bwd=3)          # the encoder's three PT blocks.
    ref = dict(from_jax_params(_np_tree(jg['encoder']), tenc))
    ref.update({'dec.' + k: v for k, v in from_jax_params(_np_tree(jg['decoder']),
                                                           tdec).items()})
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
        for k in ('total_loss', 'loss_dens', 'loss_rgb', 'loss_track', 'grad_norm'):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4, atol=2e-5,
                                       err_msg=f'step {i} {k}')
        assert bool(tm['grads_finite']) and bool(tm['params_finite'])
        jp = _np_tree(state['params'])
        ref = dict(from_jax_params(jp['encoder'], tenc))
        ref.update({'dec.' + k: v for k, v in from_jax_params(jp['decoder'], tdec).items()})
        dt = torch.cat([(t_params[n].detach() - init[n]).ravel() for n in t_params])
        dj = torch.cat([(ref[n] - init[n]).ravel() for n in t_params])
        rel = float((dt - dj).norm() / dt.norm())
        assert rel < 5e-4, (i, rel)
