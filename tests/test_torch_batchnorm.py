'''
Batch norm in training (TrainConfig.pt_norm_type 'batch'), held against the
JAX package on the CPU at tiny widths (the layer's forward against flax's
BatchNorm is tests/test_torch_train.py::test_batch_norm_train_mode_raises):
  * NormLayer('batch')'s gradients through the batch statistics against
    jax.grad of the JAX NormLayer in train mode;
  * a 3-step lockstep of the train step against JAX make_train_step with
    pt_norm_type 'batch' (tests/test_torch_train.py's fixed samplers and
    tolerances; the running statistics rtol 1e-5);
  * a step with a non-finite gradient keeps the old statistics; the val_aug
    and viz steps normalise with the batch's statistics, match JAX's
    outputs and leave the running statistics as they were;
  * a port checkpoint carries them into the JAX load_models.

Tolerances: the layer's gradients rtol 1e-4 and 1e-5 of the largest
magnitude (the backward sums over every row); lockstep as
tests/test_torch_train.py, the running statistics rtol 1e-5.
'''

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# Six test workers share eight cores: keep PyTorch's CPU pool small.
torch.set_num_threads(2)

from occlusions4d_tpu.config import TrainConfig as JTrainConfig
from occlusions4d_tpu.evaluate.inference import load_models as j_load_models
from occlusions4d_tpu.models.layers import NormLayer as JNormLayer
from occlusions4d_tpu.pipeline import PipelineConfig as JPipelineConfig
from occlusions4d_tpu.pipeline import TrainPipeline as JTrainPipeline
from occlusions4d_tpu.sampler import SamplerConfig as JSamplerConfig
from occlusions4d_tpu.train import build_optimizer as j_build_optimizer
from occlusions4d_tpu.train import make_eval_step as j_make_eval_step
from occlusions4d_tpu.train import make_train_step as j_make_train_step
from occlusions4d_tpu.train import make_viz_step as j_make_viz_step
from occlusions4d_torch.checkpoint import _torch_state, from_jax_params
from occlusions4d_torch.config import TrainConfig
from occlusions4d_torch.models.encoder import PointEncoder
from occlusions4d_torch.models.implicit import LocalImplicitField
from occlusions4d_torch.models.layers import take_batch_stats
from occlusions4d_torch.pipeline import PipelineConfig, TrainPipeline
from occlusions4d_torch.sampler import SamplerConfig
from occlusions4d_torch.train import (build_optimizer, make_eval_step, make_train_step,
                                      make_viz_step)
from test_torch_train import (_DEC, _ENC, _LWS, _NORM_CASES, _JFixedSampler,
                              _TFixedSampler, _supervision, _tiny_batch, _tiny_trainer,
                              norm_pair)


def _t(a):
    return torch.tensor(np.asarray(a))


# ----------------------------------------------------------- the layer --

def test_batch_norm_gradient_matches_flax():
    '''The input and parameter gradients through the batch statistics
    against jax.grad of the JAX NormLayer in train mode (inputs of mean 0:
    at a mean of 1e3 both backward passes are mostly rounding).'''
    rng = np.random.default_rng(1)
    jnorm = JNormLayer('batch')
    for shape, offset in (_NORM_CASES[0], _NORM_CASES[3]):
        x, variables, layer = norm_pair(rng, shape, offset)
        go = rng.standard_normal(shape).astype(np.float32)
        rows = x.reshape(-1, shape[-1])

        def f(v, xr):
            y, _ = jnorm.apply(v, xr, train=True, mutable=['batch_stats'])
            return jnp.sum(y * go.reshape(rows.shape))

        jgv, jgx = jax.grad(f, argnums=(0, 1))(variables, jnp.asarray(rows))
        xt = _t(x).requires_grad_(True)
        (layer.train()(xt) * _t(go)).sum().backward()
        jgx = np.asarray(jgx).reshape(shape)
        np.testing.assert_allclose(xt.grad.numpy(), jgx, rtol=1e-4,
                                   atol=1e-5 * np.abs(jgx).max(), err_msg=str(shape))
        for t, ref in ((layer.weight.grad, jgv['params']['norm']['scale']),
                       (layer.bias.grad, jgv['params']['norm']['bias'])):
            np.testing.assert_allclose(t.numpy(), np.asarray(ref), rtol=1e-4,
                                       atol=1e-5 * np.abs(np.asarray(ref)).max())


# ------------------------------------------------------------ lockstep --

_ENC_BN = dict(_ENC, pt_norm_type='batch')
# The biases of the linear layers a batch norm follows: the norm subtracts
# their contribution, so their gradients are zero but for rounding.
_BEFORE_NORM = ('blocks.1.mlp.0.bias', 'blocks.3.mlp.0.bias')


def _bn_setup():
    '''The JAX and port pipelines of test_torch_train's lockstep with batch
    norm in the encoder's DownTransitions, from one flax init (the running
    statistics moved off their init so that every update shows).'''
    from occlusions4d_tpu.models.encoder import PointEncoder as JEncoder
    from occlusions4d_tpu.models.implicit import LocalImplicitField as JField
    rng = np.random.RandomState(3)
    pcl = (rng.rand(1, 256, 8) * 2.0 - 1.0).astype(np.float32)
    queries, targets = _supervision(2, 96, 13)
    jenc, jdec = JEncoder(**_ENC_BN), JField(**_DEC)
    enc_vars = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(pcl))
    enc_vars = jax.tree_util.tree_map(np.asarray, enc_vars)
    stats = enc_vars['batch_stats']
    enc_vars['batch_stats'] = jax.tree_util.tree_map(
        lambda a: (a + rng.rand(*a.shape).astype(np.float32)), stats)
    ab, fg, _ = jenc.apply(enc_vars, jnp.asarray(pcl))
    dec_vars = jax.jit(jdec.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 4)), ab, fg)
    pcfg = dict(color_mode='rgb_nosigmoid', semantic_classes=13, past_frames=2,
                future_frames=0, **_LWS)
    jpipe = JTrainPipeline(jenc, jdec, JSamplerConfig(), JPipelineConfig(**pcfg),
                           remat=True, fused_decoder='off')
    jpipe.sampler = _JFixedSampler(queries, targets, 48)
    tenc, tdec = PointEncoder(**_ENC_BN), LocalImplicitField(**_DEC)
    tenc.load_state_dict(from_jax_params(enc_vars, tenc), strict=True)
    tdec.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, dec_vars),
                                         tdec), strict=True)
    tpipe = TrainPipeline(tenc.train(), tdec.train(), SamplerConfig(), PipelineConfig(**pcfg))
    tpipe.sampler = _TFixedSampler(queries, targets, 48)
    batch = dict(pcl_input=pcl, pcl_target=np.zeros((1, 2, 8, 9), np.float32),
                 pcl_target_valid=np.ones((1, 2, 8), bool),
                 valo_ids=np.zeros((1, 4), np.int32), num_valo_ids=np.zeros((1,), np.int32))
    return jpipe, tpipe, dict(encoder=enc_vars, decoder=dec_vars), batch


def _stats(encoder):
    return {k: v.detach().clone() for k, v in encoder.state_dict().items()
            if k.endswith(('running_mean', 'running_var'))}


def _assert_stats_close(encoder, jparams, what):
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams['encoder']), encoder)
    got = _stats(encoder)
    assert len(got) == 4, sorted(got)         # two DownTransitions, mean and var.
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=f'{what} {k}')


@pytest.fixture(scope='module')
def bn_lockstep():
    jpipe, tpipe, jparams, batch = _bn_setup()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: _t(v) for k, v in batch.items()}
    cfg = dict(learn_rate=1e-3, num_epochs=20, lr_decay=0.5, gradient_clip=0.2)
    tx, _ = j_build_optimizer(JTrainConfig(**cfg, mixed_precision=False), 1000)
    state = dict(params=jparams, opt_state=tx.init(jparams), step=jnp.zeros((), jnp.int32))
    named = {f'{net}.{n}': p for net in ('encoder', 'decoder')
             for n, p in getattr(tpipe, net).named_parameters()}
    opt = build_optimizer(TrainConfig(**cfg), 1000, list(named.values()))
    # Parameters whose gradient is zero but for rounding: a bias a batch norm
    # subtracts again (_BEFORE_NORM, and the last bias of a residual block
    # feeding one), a bias the attention's softmax is invariant to. AdamW
    # moves them by about lr x sign(rounding), each package by its own
    # rounding, and the running means follow the biases before the norms:
    # after every step they are set to JAX's (values and moments, _resync),
    # and the parameter deltas leave them out.
    g = dict(zip(named, torch.autograd.grad(tpipe.loss(tbatch, torch.Generator())[0],
                                            list(named.values()))))
    take_batch_stats(tpipe.encoder)
    scale = max(float(v.abs().max()) for v in g.values())
    noise = {n for n, v in g.items() if float(v.abs().max()) < 1e-5 * scale}
    assert {'encoder.' + n for n in _BEFORE_NORM} <= noise
    assert sum(named[n].numel() for n in noise) < 0.02 * sum(p.numel() for p in named.values())
    return dict(jpipe=jpipe, tpipe=tpipe, state=state, jstep=j_make_train_step(jpipe, tx),
                tstep=make_train_step(tpipe, opt), jbatch=jbatch, tbatch=tbatch, opt=opt,
                named=named, init={n: p.detach().clone() for n, p in named.items()},
                noise=noise,
                init_stats=_stats(tpipe.encoder))


@torch.no_grad()
def _resync(lk, state):
    '''The rounding-noise parameters, and their AdamW moments, set to JAX's.'''
    jp = jax.tree_util.tree_map(np.asarray, state['params'])
    adam = state['opt_state'][1].inner_state[0]        # masked(adamw)'s Adam state.
    trees = dict(p=jp, mu=adam.mu, nu=adam.nu)
    for i, name in enumerate(lk['named']):
        if name not in lk['noise']:
            continue
        net, n = name.split('.', 1)
        mod = getattr(lk['tpipe'], net)
        for key, dst in (('p', lk['named'][name]), ('mu', lk['opt'].mu[i]),
                         ('nu', lk['opt'].nu[i])):
            tree = {'params': jax.tree_util.tree_map(np.asarray, trees[key][net]['params'])}
            dst.copy_(_torch_state(tree)[n])


def test_batch_norm_train_step_lockstep_with_jax(bn_lockstep):
    '''3 steps against JAX make_train_step: losses and gradient norm, the
    parameters' deltas (but those of the rounding-noise gradients), and the
    running statistics
    after every step (they move: 0.9 r + 0.1 batch from their shifted
    start).'''
    lk = bn_lockstep
    state = lk['state']
    for i in range(3):
        state, jm = lk['jstep'](state, lk['jbatch'], jax.random.PRNGKey(i))
        lk['state'] = state            # the step donates the state it was given.
        tm = lk['tstep'](lk['tbatch'], torch.Generator())
        for k in ('total_loss', 'loss_dens', 'loss_rgb', 'loss_track', 'grad_norm'):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4, atol=2e-5,
                                       err_msg=f'step {i} {k}')
        assert bool(tm['grads_finite']) and bool(tm['params_finite'])
        assert bool(jm['grads_finite'])
        _assert_stats_close(lk['tpipe'].encoder, state['params'], f'step {i}')
        _resync(lk, state)
        jp = jax.tree_util.tree_map(np.asarray, state['params'])
        dt, dj = [], []
        for net in ('encoder', 'decoder'):
            mod = getattr(lk['tpipe'], net)
            ref = from_jax_params(jp[net], mod)
            for n, p in mod.named_parameters():
                if f'{net}.{n}' in lk['noise']:
                    continue
                p0 = lk['init'][net + '.' + n]
                dt.append((p.detach() - p0).ravel())
                dj.append((ref[n] - p0).ravel())
        dt, dj = torch.cat(dt), torch.cat(dj)
        rel = float((dt - dj).norm() / dt.norm())
        assert rel < 5e-4, (i, rel)
    moved = _stats(lk['tpipe'].encoder)
    assert all(not torch.equal(moved[k], v) for k, v in lk['init_stats'].items())


def test_batch_norm_skipped_eval_and_viz_steps_keep_statistics(bn_lockstep):
    '''After the lockstep: a step with a non-finite gradient keeps the
    statistics (JAX's too); the val_aug (eval) and viz steps match JAX's
    outputs, which normalise with the batch's statistics, and leave the
    running statistics unchanged.'''
    lk = bn_lockstep
    state = lk['state']
    before = _stats(lk['tpipe'].encoder)
    bad_j = dict(lk['jbatch'], pcl_input=jnp.full_like(lk['jbatch']['pcl_input'], jnp.nan))
    bad_t = dict(lk['tbatch'], pcl_input=torch.full_like(lk['tbatch']['pcl_input'],
                                                         float('nan')))
    state, jm = lk['jstep'](state, bad_j, jax.random.PRNGKey(9))
    tm = lk['tstep'](bad_t, torch.Generator())
    assert not bool(jm['grads_finite']) and not bool(tm['grads_finite'])
    assert bool(tm['params_finite'])
    after = _stats(lk['tpipe'].encoder)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    _assert_stats_close(lk['tpipe'].encoder, state['params'], 'skipped step')

    jev = j_make_eval_step(lk['jpipe'])(state, lk['jbatch'], jax.random.PRNGKey(3))
    tev = make_eval_step(lk['tpipe'])(lk['tbatch'], torch.Generator())
    for k in ('total_loss', 'loss_dens', 'loss_rgb', 'loss_track'):
        np.testing.assert_allclose(float(tev[k]), float(jev[k]), rtol=2e-4, atol=2e-5,
                                   err_msg=f'eval {k}')
    jviz = j_make_viz_step(lk['jpipe'])(state, lk['jbatch'], jax.random.PRNGKey(4))
    tviz = make_viz_step(lk['tpipe'])(lk['tbatch'], torch.Generator())
    for k in ('abstract', 'implicit_output', 'features_global'):
        ref = np.asarray(jviz[k])
        np.testing.assert_allclose(tviz[k].numpy(), ref, rtol=1e-3,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=f'viz {k}')
    # The eval-mode (running-statistics) forward differs from the batch one.
    tpipe = lk['tpipe']
    with torch.no_grad():
        a_train = tpipe.encoder(lk['tbatch']['pcl_input'])[0]
        a_eval = tpipe.encoder.eval()(lk['tbatch']['pcl_input'])[0]
    tpipe.encoder.train()
    assert not torch.allclose(a_train[..., 3:], a_eval[..., 3:], atol=1e-4)
    take_batch_stats(tpipe.encoder)
    after = _stats(lk['tpipe'].encoder)
    assert all(torch.equal(after[k], v) for k, v in before.items())


def test_batch_norm_checkpoint_loads_in_jax(tmp_path):
    '''A port Trainer with pt_norm_type 'batch' steps twice and saves; the
    JAX load_models reads the running statistics, bit for bit, under
    batch_stats, and the port's load_models gives them back.'''
    from occlusions4d_torch.evaluate.inference import load_models
    tr = _tiny_trainer(pt_norm_type='batch', output_path=str(tmp_path / 'run'))
    init = _stats(tr.encoder)
    batch = _tiny_batch()
    for _ in range(2):
        m = tr.step(batch)
        assert np.isfinite(float(m['total_loss']))
    stats = _stats(tr.encoder)
    assert all(not torch.equal(stats[k], v) for k, v in init.items())
    tr.save(0)
    loaded = j_load_models(str(tmp_path / 'run'))
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, loaded['params']['encoder']),
                          tr.encoder)
    assert all(torch.equal(ref[k], v) for k, v in stats.items())
    mine = load_models(str(tmp_path / 'run'), device='cpu', logger=None)
    sd = mine['encoder'].state_dict()
    assert all(torch.equal(sd[k], v) for k, v in stats.items())
    assert not mine['encoder'].training
    assert os.path.isfile(str(tmp_path / 'run' / 'model_0.pkl'))
