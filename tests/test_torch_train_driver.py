'''
The port's train driver (occlusions4d_torch: config.train_args,
data.create_train_val_loaders, checkpoint save / load, Trainer.run_epoch /
save / resume / fit, train.main and python -m occlusions4d_torch.train)
held against the JAX package's on the CPU, at tiny widths:
  (1) train_args against the JAX train_args on the gv1, cv1 and convergence
      command lines, every field, the tag and the output path equal (device
      aside: 'cuda' here, 'tpu' there), --resume v6 resolved alike; each
      flag the port does not implement (--checkpoint_format orbax) raises
      NotImplementedError naming its ROADMAP item, and --check_numerics,
      --watch_networks, --use_wandb, --profile_steps, --fused_decoder off,
      --pt_norm_type batch, --worker_mode process, a .pth --resume,
      --data_parallel 2 and --query_parallel 2 parse as in the JAX package;
  (2) the train and val loaders against the JAX loaders on synthetic GREATER
      and CARLA data, 2 epochs, 0 and 2 workers, tracking on: the same
      steps_per_epoch and every batch equal bit for bit;
  (3) Trainer.run_epoch against the JAX Trainer.run_epoch over 2 epochs of
      train and val_aug across an LR boundary, from one init, on the same
      batches (their positions redrawn uniformly), both samplers fixed as
      tests/test_torch_train.py fixes them and FPS starting at point 0 in
      both: every logged scalar within rtol
      2e-4 / atol 2e-5 and the parameter deltas within 5e-4 relative L2 of
      JAX's (the lockstep tolerances, tests/test_torch_train.py);
  (4) checkpoints both ways: a port-written pkl loads through the JAX
      load_checkpoint and load_models (params bit-equal, meta complete) and
      resumes in the port (params, mu, nu, count equal); a JAX-written pkl
      resumes in the port (params, mu, nu and count equal to the JAX state's)
      and one more step is in lockstep with JAX's (the tolerances of (3));
  (5) a run resumed after epoch 0 equals the unbroken run bit for bit;
  (6) the guards: 11 host-side data errors tolerated, the 12th re-raised; a
      NaN parameter raises within one step; a non-finite gradient is
      skipped and logged;
  (7) the committed convergence run's properties (tests/assets/convergence/
      trajectory.json's argv and scenes) with the torch driver: LR
      milestones, rolled checkpoints, falling val loss, resume equality
      (tests/test_convergence.py:35-74). JAX's losses are not a gate: the
      two packages draw different random streams;
  (8) python -m occlusions4d_torch.train --device cpu in a subprocess, its
      checkpoint evaluated by the port's eval driver in another, with jax,
      flax, optax and occlusions4d_tpu blocked in both.
'''

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# Six test workers share eight cores: keep PyTorch's CPU pool small.
torch.set_num_threads(2)

from occlusions4d_tpu import checkpoint as j_ckpt
from occlusions4d_tpu import train as j_train
from occlusions4d_tpu.config import train_args as j_train_args
from occlusions4d_tpu.data import loader as j_loader
from occlusions4d_tpu.evaluate.inference import load_models as j_load_models
from occlusions4d_tpu.models import factory as j_factory
from occlusions4d_tpu.utils.logvis import StepLogger as JStepLogger
from occlusions4d_torch import checkpoint as t_ckpt
from occlusions4d_torch import train as t_train
from occlusions4d_torch.config import train_args
from occlusions4d_torch.data import loader as t_loader
from occlusions4d_torch.data import synthetic
from occlusions4d_torch.models import factory as t_factory
from occlusions4d_torch.utils import profiling
from occlusions4d_torch.utils.logvis import StepLogger
from test_torch_train import _JFixedSampler, _supervision, _TFixedSampler

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ARTIFACT = os.path.join(_ROOT, 'tests', 'assets', 'convergence', 'trajectory.json')

# The reference README's gv1 recipe (MIGRATION.md:19-31) and a cv1 command
# line (bench.py:385-393's configuration).
_GV1_ARGV = [
    '--name', 'gv1', '--num_workers', '52', '--batch_size', '3', '--up_down_blocks', '3',
    '--transition_factor', '3', '--pt_feat_dim', '36', '--pt_num_neighbors', '16',
    '--pt_norm_type', 'none', '--down_neighbors', '12', '--n_points', '14336',
    '--n_data_rnd', '14336', '--video_len', '12', '--frame_skip', '2', '--pt_cube_bounds', '5',
    '--cr_cube_bounds', '5', '--implicit_mlp_blocks', '6', '--local_implicit_mode',
    'attention', '--cross_attn_layers', '2', '--cross_attn_neighbors', '14',
    '--abstract_levels', '1', '--color_mode', 'rgb_nosigmoid', '--num_epochs', '20',
    '--density_lw', '1.0', '--color_lw', '1.0', '--segmentation_lw', '0.0', '--tracking_lw',
    '1.0', '--point_occupancy_radius', '0.2', '--air_sampling_ratio', '1.5',
    '--point_sample_bias', 'none', '--past_frames', '4', '--future_frames', '0']
_CV1_ARGV = [
    '--name', 'cv1', '--batch_size', '3', '--up_down_blocks', '3', '--transition_factor',
    '3', '--pt_feat_dim', '36', '--pt_num_neighbors', '16', '--pt_norm_type', 'layer',
    '--down_neighbors', '12', '--n_points', '14336', '--n_data_rnd', '14336', '--video_len',
    '12', '--frame_skip', '3', '--pt_cube_bounds', '20', '--cr_cube_bounds', '16',
    '--cube_mode', '4', '--implicit_mlp_blocks', '6', '--cross_attn_layers', '2',
    '--cross_attn_neighbors', '14', '--abstract_levels', '2', '--color_mode',
    'rgb_nosigmoid', '--segmentation_lw', '0.6', '--color_lw', '0.0', '--tracking_lw',
    '0.0', '--semantic_classes', '13', '--air_sampling_ratio', '1.4',
    '--point_sample_bias', 'low_moving_ivalo_sembal', '--sample_bias', 'move_occl',
    '--past_frames', '4', '--use_data_frac', '0.5', '--mixed_precision', 'true']

# The tiny model of the lockstep, guard and resume tests.
_TINY = dict(n_points=256, n_data_rnd=512, video_len=4, frame_skip=2, past_frames=2,
             future_frames=0, pt_cube_bounds=5.0, pt_feat_dim=8, up_down_blocks=2,
             transition_factor=3, pt_num_neighbors=8, down_neighbors=6, global_size=16,
             num_cr_local_feats=4, implicit_mlp_blocks=3, cross_attn_layers=2,
             cross_attn_neighbors=6, cr_attn_type='cc', num_cr_solid=48,
             color_mode='rgb_nosigmoid', color_lw=1.0, tracking_lw=1.0, batch_size=2,
             seed=5, data_parallel=1, num_workers=0, use_data_frac=0.02)


def _argv(kw):
    out = []
    for k, v in kw.items():
        out += [f'--{k}', str(v)]
    return out


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    '''Synthetic GREATER and CARLA datasets with train and val stages.'''
    base = tmp_path_factory.mktemp('train_driver')
    g, c = str(base / 'greater'), str(base / 'data_carla')
    synthetic.make_greater_dataset(g, num_scenes=2, num_views=2, num_frames=14,
                                   image_size=28, stages=('train', 'val', 'test'))
    synthetic.make_carla_dataset(c, num_scenes=1, num_frames=44, points_per_frame=900,
                                 stages=('train', 'val'))
    return dict(greater=g, carla=c, base=base)


# ------------------------------------------------------------------ (1) --

@pytest.mark.parametrize('name', ['gv1', 'cv1', 'convergence'])
def test_train_args_match_jax(name, tmp_path):
    argv = dict(gv1=_GV1_ARGV, cv1=_CV1_ARGV)[name] if name != 'convergence' else \
        json.load(open(_ARTIFACT))['argv']
    argv = argv + ['--data_path', str(tmp_path / 'd'), '--checkpoint_root',
                   str(tmp_path / 'ck'), '--log_root', str(tmp_path / 'logs')]
    got, ref = dataclasses.asdict(train_args(argv)), dataclasses.asdict(j_train_args(argv))
    assert got.pop('device') == 'cuda' and ref.pop('device') == 'tpu'
    assert got == ref
    assert got['tag'] and got['output_path'] == os.path.join(str(tmp_path / 'ck'), got['tag'])
    # --resume v6: the unique checkpoints/v6_*/ directory's rolling file.
    run = tmp_path / 'ck' / f'v6_{got["tag"]}'
    run.mkdir(parents=True)
    for fn in ('model_0.pkl', 'checkpoint.pkl'):
        (run / fn).write_bytes(b'')
    argv += ['--resume', 'v6']
    assert train_args(argv).resume == j_train_args(argv).resume == str(run / 'checkpoint.pkl')


@pytest.mark.parametrize('flag,value,item', [
    ('check_numerics', 'true', 7),
    ('watch_networks', 'true', 7), ('use_wandb', 'true', 7), ('profile_steps', '3', 7),
    ('fused_decoder', 'off', 7), ('checkpoint_format', 'orbax', 5)])
def test_train_args_refuse_unported_flags(flag, value, item, tmp_path):
    '''The ROADMAP Queue 1 item 7 flags (the train step's observability, the
    decoder's module path) parse as in the JAX package, every field equal
    but the device; --checkpoint_format orbax (item 5) alone still raises
    NotImplementedError naming its item.'''
    argv = _argv(_TINY) + ['--checkpoint_root', str(tmp_path)]
    assert train_args(argv).device == 'cuda'
    assert train_args(argv + ['--device', 'cpu']).device == 'cpu'
    ref = dataclasses.asdict(j_train_args(argv + [f'--{flag}', value]))  # JAX takes it.
    if item == 5:
        with pytest.raises(NotImplementedError, match=f'item {item}'):
            train_args(argv + [f'--{flag}', value])
        return
    got = dataclasses.asdict(train_args(argv + [f'--{flag}', value]))
    assert got.pop('device') == 'cuda' and ref.pop('device') == 'tpu'
    assert got == ref and str(got[flag]).lower() == value


@pytest.mark.parametrize('flag,value', [
    ('pt_norm_type', 'batch'), ('worker_mode', 'process'), ('resume', 'weights.pth'),
    ('data_parallel', '2'), ('query_parallel', '2')])
def test_train_args_accept_ported_flags(flag, value, tmp_path):
    '''The flags the port took on with batch norm in training, fork loader
    workers, the reference .pth warm start, data-parallel training and the
    query-sharded eval's flag (parsed and unused on the train side, as in
    the JAX package) parse as in the JAX package (every field equal but the
    device).'''
    argv = _argv(_TINY) + ['--checkpoint_root', str(tmp_path)]
    if flag == 'resume':
        value = str(tmp_path / value)
        open(value, 'wb').close()
    got = dataclasses.asdict(train_args(argv + [f'--{flag}', value]))
    ref = dataclasses.asdict(j_train_args(argv + [f'--{flag}', value]))
    assert got.pop('device') == 'cuda' and ref.pop('device') == 'tpu'
    assert got == ref and str(got[flag]) == value


# ------------------------------------------------------------------ (2) --

def _assert_batches_equal(jb, tb):
    assert sorted(jb) == sorted(tb)
    for key in jb:
        if key == 'meta_data':
            for jm, tm in zip(jb[key], tb[key]):
                assert sorted(jm) == sorted(tm)
                for k in jm:
                    np.testing.assert_array_equal(np.asarray(jm[k]), np.asarray(tm[k]),
                                                  err_msg=k)
        else:
            assert jb[key].dtype == tb[key].dtype, key
            np.testing.assert_array_equal(jb[key], tb[key], err_msg=key)


@pytest.mark.parametrize('kind', ['greater', 'carla'])
@pytest.mark.parametrize('workers', [0, 2])
def test_train_val_loaders_match_jax(data, kind, workers):
    kw = dict(_TINY, num_workers=workers, tracking_lw=1.0, data_path=data[kind])
    if kind == 'carla':
        kw.update(n_points=512, n_data_rnd=1024, cr_cube_bounds=16.0)
    argv = _argv(kw) + ['--output_path', '']
    jcfg, tcfg = j_train_args(argv), train_args(argv)
    jl = j_loader.create_train_val_loaders(jcfg, JStepLogger(context='j'))
    tl = t_loader.create_train_val_loaders(tcfg, StepLogger(context='t'))
    assert jl[0] == tl[0] == kind and jl[3] == tl[3]
    for j, t in ((jl[1], tl[1]), (jl[2], tl[2])):
        assert j.steps_per_epoch == t.steps_per_epoch >= 1
        for epoch in (0, 1):
            jbs, tbs = list(j.epoch(epoch)), list(t.epoch(epoch))
            assert len(jbs) == len(tbs) == t.steps_per_epoch
            for jb, tb in zip(jbs, tbs):
                _assert_batches_equal(jb, tb)
    tb0 = list(tl[1].epoch(0))[0]
    assert tb0['pcl_input'].shape[:2] == (2, kw['n_points'])
    if kind == 'greater':   # track supervision drawn ('random' with tracking_lw > 0).
        assert np.isin(tb0['pcl_target'][..., -1], (-1.0, 0.0, 1.0)).all()


# ------------------------------------------------------------------ (3) --

_STEPS = 2               # train steps per epoch; val_aug has 1.
_LOCK_KEYS = ('total_loss', 'loss_dens', 'loss_rgb', 'loss_track')


def _no_random_fps(monkeypatch):
    '''FPS from point 0 in both packages (their random starts draw from
    different streams).'''
    for mod in (j_factory, t_factory):
        orig = mod.build_encoder_args
        monkeypatch.setattr(mod, 'build_encoder_args',
                            lambda *a, _o=orig: dict(_o(*a), fps_random_start=False))


def _tiny_argv(root, out, **over):
    return _argv(dict(_TINY, **over)) + ['--data_path', root, '--output_path', out]


def _torch_params(net_params, enc, dec):
    ref = dict(t_ckpt.from_jax_params(net_params['encoder'], enc))
    ref.update({'dec.' + k: v for k, v in
                t_ckpt.from_jax_params(net_params['decoder'], dec).items()})
    return ref


def _named(tr):
    return dict(tr.encoder.named_parameters(),
                **{'dec.' + n: p for n, p in tr.decoder.named_parameters()})


def _rel_delta(tr, jparams, init):
    cur = _named(tr)
    ref = _torch_params(jparams, tr.encoder, tr.decoder)
    dt = torch.cat([(cur[n].detach() - init[n]).ravel() for n in cur])
    dj = torch.cat([(ref[n] - init[n]).ravel() for n in cur])
    return float((dt - dj).norm() / dt.norm())


@pytest.fixture(scope='module')
def lockstep(data, tmp_path_factory):
    '''The JAX side: a Trainer over 2 epochs (num_epochs 3: the LR boundary
    at epoch 1) of train and val_aug on the first loader batches, its
    logged scalars and parameters after each epoch, its pkl after epoch 1,
    then one more train step.'''
    mp = pytest.MonkeyPatch()
    _no_random_fps(mp)
    mp.setattr(j_train, 'LOG_EVERY', 1)
    out = str(tmp_path_factory.mktemp('jax_ck'))
    cfg = j_train_args(_tiny_argv(data['greater'], out, num_epochs=3, lr_decay=0.5))
    _, loader, _, _ = j_loader.create_train_val_loaders(cfg, JStepLogger(context='j'))
    batches = list(loader.epoch(0))[:_STEPS + 1]
    # Positions drawn uniformly: the synthetic scenes' clouds (unprojected
    # pixel grids) hold near-ties whose kNN rank the two packages' distance
    # formulas round apart.
    rng = np.random.RandomState(3)
    for b in batches:
        b['pcl_input'][..., :3] = rng.rand(*b['pcl_input'].shape[:2], 3) * 4.0 - 2.0
    queries, targets = _supervision(2, 96, 13)
    jtr = j_train.Trainer(cfg, 'greater', logger=JStepLogger(context='jlock'))
    jtr.init_state(batches[0], steps_per_epoch=_STEPS)
    jtr.pipeline.sampler = _JFixedSampler(queries, targets, 48)
    init = jax.tree_util.tree_map(np.asarray, jtr.state['params'])
    hist, params = [], []
    for epoch in (0, 1):
        hist.append(jtr.run_epoch(epoch, 'train', iter(batches[:_STEPS])))
        params.append(jax.tree_util.tree_map(np.asarray, jtr.state['params']))
        hist.append(jtr.run_epoch(epoch, 'val_aug', iter(batches[_STEPS:])))
    jtr.save(1)
    opt = jax.tree_util.tree_map(np.asarray, jtr.state['opt_state'])
    adam = opt[1].inner_state[0]            # masked(adamw)'s ScaleByAdamState.
    cont = jtr.run_epoch(2, 'train', iter(batches[:1]))
    cont_params = jax.tree_util.tree_map(np.asarray, jtr.state['params'])
    mp.undo()
    return dict(cfg_argv=_tiny_argv(data['greater'], out, num_epochs=3, lr_decay=0.5),
                batches=batches, sup=(queries, targets), init=init, hist=hist,
                params=params, adam=adam, cont=cont, cont_params=cont_params, out=out)


def _torch_lock_trainer(lk, monkeypatch):
    _no_random_fps(monkeypatch)
    monkeypatch.setattr(t_train, 'LOG_EVERY', 1)
    cfg = train_args(lk['cfg_argv'])
    cfg.output_path = ''
    tr = t_train.Trainer(cfg, 'greater', device='cpu', logger=StepLogger(context='tlock'))
    return tr


def _assert_logged_close(t_hist, j_hist, what):
    assert len(t_hist) == len(j_hist), what
    for i, (tm, jm) in enumerate(zip(t_hist, j_hist)):
        keys = _LOCK_KEYS + (('grad_norm',) if 'grad_norm' in jm else ())
        for k in keys:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4, atol=2e-5,
                                       err_msg=f'{what} step {i} {k}')


def test_run_epoch_lockstep_with_jax(lockstep, monkeypatch, tmp_path):
    lk = lockstep
    tr = _torch_lock_trainer(lk, monkeypatch)
    tr.init_state(params=lk['init'], steps_per_epoch=_STEPS)
    tr.pipeline.sampler = _TFixedSampler(*lk['sup'], 48)
    init = {n: p.detach().clone() for n, p in _named(tr).items()}
    lrs = []
    profiling.reset_spans()
    for epoch in (0, 1):
        # Epoch 1's train steps in a device trace: its spans are recorded.
        with profiling.device_trace(str(tmp_path / 'trace'), enabled=epoch == 1):
            th = tr.run_epoch(epoch, 'train', iter(lk['batches'][:_STEPS]))
        _assert_logged_close(th, lk['hist'][2 * epoch], f'train epoch {epoch}')
        assert all(bool(m['grads_finite']) and bool(m['params_finite']) for m in th)
        rel = _rel_delta(tr, lk['params'][epoch], init)
        assert rel < 5e-4, (epoch, rel)
        lrs.append(float(tr.optimizer.lr(tr.optimizer.count - 1)))
        vh = tr.run_epoch(epoch, 'val_aug', iter(lk['batches'][_STEPS:]))
        _assert_logged_close(vh, lk['hist'][2 * epoch + 1], f'val_aug epoch {epoch}')
    assert lrs == [pytest.approx(1e-3), pytest.approx(5e-4)]   # the LR boundary crossed.
    assert tr.step_count == 2 * _STEPS and int(tr.optimizer.count) == 2 * _STEPS
    totals = profiling.span_totals()
    assert set(totals) >= {'train.data', 'train.h2d', 'train_step_0', 'train.log_sync'}
    assert totals['train.epoch']['calls'] == 1
    profiling.reset_spans()


# ------------------------------------------------------------------ (4) --

def test_jax_checkpoint_resumes_in_port(lockstep, monkeypatch):
    lk = lockstep
    tr = _torch_lock_trainer(lk, monkeypatch)
    tr.resume(os.path.join(lk['out'], 'model_1.pkl'), steps_per_epoch=_STEPS)
    assert tr.start_epoch == 2 and tr.step_count == 2 * _STEPS
    ref = _torch_params(lk['params'][1], tr.encoder, tr.decoder)
    assert all(torch.equal(p.detach(), ref[n]) for n, p in _named(tr).items())
    adam = lk['adam']
    assert int(tr.optimizer.count) == int(adam.count) == 2 * _STEPS
    for key, mine in (('mu', tr.optimizer.mu), ('nu', tr.optimizer.nu)):
        ref = _torch_params(getattr(adam, key), tr.encoder, tr.decoder)
        assert all(torch.equal(t, ref[n]) for n, t in zip(_named(tr), mine)), key
    # One more step in lockstep with the JAX Trainer's.
    tr.pipeline.sampler = _TFixedSampler(*lk['sup'], 48)
    before = {n: p.detach().clone() for n, p in _named(tr).items()}
    th = tr.run_epoch(2, 'train', iter(lk['batches'][:1]))
    _assert_logged_close(th, lk['cont'], 'continued step')
    assert _rel_delta(tr, lk['cont_params'], before) < 5e-4


def test_port_checkpoint_loads_in_jax_and_port(data, tmp_path):
    cfg = train_args(_tiny_argv(data['greater'], str(tmp_path / 'run'), num_epochs=2))
    cfg.device = 'cpu'
    tr = t_train.Trainer(cfg, 'greater', logger=StepLogger(context='tsave')).init_state(
        steps_per_epoch=2)
    _, loader, _, _ = t_loader.create_train_val_loaders(cfg, tr.logger)
    tr.run_epoch(0, 'train', loader.epoch(0), num_steps=2)
    tr.save(0)
    assert sorted(os.listdir(cfg.output_path)) == ['checkpoint.pkl', 'model_0.pkl']
    # The JAX package reads it: params bit-equal to the port's modules.
    payload = j_ckpt.load_checkpoint(cfg.output_path)
    assert payload['epoch'] == 0 and set(payload['meta']) == {
        'config', 'encoder_args', 'decoder_args', 'sampler_args', 'data_kind'}
    assert payload['meta']['encoder_args'] == tr.encoder_args
    assert payload['meta']['config']['n_points'] == cfg.n_points
    loaded = j_load_models(cfg.output_path)
    assert loaded['data_kind'] == 'greater' and loaded['epoch'] == 0
    for net, mod in (('encoder', tr.encoder), ('decoder', tr.decoder)):
        exported = j_ckpt.export_torch_state_dict(loaded['params'][net], net)
        sd = mod.state_dict()
        assert sorted(exported) == sorted(sd)
        assert all(np.array_equal(exported[k], sd[k].numpy()) for k in sd), net
    # The port resumes it: params, mu, nu and count equal.
    tr2 = t_train.Trainer(cfg, 'greater', logger=StepLogger(context='tload'))
    tr2.resume(os.path.join(cfg.output_path, 'model_0.pkl'), steps_per_epoch=2)
    assert tr2.start_epoch == 1 and tr2.step_count == 2
    assert int(tr2.optimizer.count) == int(tr.optimizer.count) == 2
    for a, b in ((tr.optimizer.params, tr2.optimizer.params), (tr.optimizer.mu,
                                                               tr2.optimizer.mu),
                 (tr.optimizer.nu, tr2.optimizer.nu)):
        assert all(torch.equal(x.detach(), y.detach()) for x, y in zip(a, b))


# ------------------------------------------------------------------ (5) --

def _scalars(trainer):
    return {row['epoch']: {k: v for k, v in row.items() if k.endswith('total_loss')}
            for row in trainer.logger.scalar_history}


def test_resumed_run_equals_unbroken(data, tmp_path, monkeypatch):
    monkeypatch.setattr(t_train, 'LOG_EVERY', 1)
    argv = _argv(dict(_TINY, num_epochs=2)) + [
        '--device', 'cpu', '--data_path', data['greater'], '--name', 'res',
        '--checkpoint_root', str(tmp_path / 'ck'), '--log_root', str(tmp_path / 'logs')]
    full = t_train.main(train_args(argv))
    cfg = train_args(argv + ['--resume', 'res', '--log_root', str(tmp_path / 'logs2')])
    assert cfg.resume == os.path.join(full.cfg.output_path, 'checkpoint.pkl')
    cfg.resume = os.path.join(full.cfg.output_path, 'model_0.pkl')
    cfg.output_path = str(tmp_path / 'resumed')
    resumed = t_train.main(cfg)
    assert resumed.start_epoch == 1 and resumed.step_count == full.step_count
    assert _scalars(resumed)[1] == _scalars(full)[1]
    for a, b in ((full.optimizer.params, resumed.optimizer.params),
                 (full.optimizer.mu, resumed.optimizer.mu),
                 (full.optimizer.nu, resumed.optimizer.nu)):
        assert all(torch.equal(x.detach(), y.detach()) for x, y in zip(a, b))
    assert sorted(os.listdir(cfg.output_path)) == ['checkpoint.pkl', 'model_1.pkl']


# ------------------------------------------------------------------ (6) --

@pytest.fixture(scope='module')
def guard_setup(data):
    cfg = train_args(_tiny_argv(data['greater'], ''))
    cfg.device = 'cpu'
    tr = t_train.Trainer(cfg, 'greater', logger=StepLogger(context='guard'))
    _, loader, _, _ = t_loader.create_train_val_loaders(cfg, tr.logger)
    return tr, list(loader.epoch(0))[:3]


def _fresh(tr):
    tr.init_state(seed=0, steps_per_epoch=4)
    errors = []
    tr.logger.error = lambda msg: errors.append(str(msg))
    tr.logger.exception = lambda e: errors.append(repr(e))
    return errors


def test_guard_tolerates_eleven_data_errors(guard_setup):
    tr, batches = guard_setup
    errors = _fresh(tr)
    tr.run_epoch(0, 'train', iter([batches[0]] + [42] * 11 + [batches[1]]))
    assert len(errors) == 11 and tr.step_count == 2
    errors = _fresh(tr)
    with pytest.raises(AttributeError):
        tr.run_epoch(0, 'train', iter([batches[0]] + [42] * 12 + [batches[1]]))
    assert len(errors) == 11


def test_guard_raises_on_nan_parameter(guard_setup):
    '''The parameter poisoned while step 2's batch is fetched: step 2's guard
    is read after step 3 is queued, the raise precedes step 4.'''
    tr, batches = guard_setup
    _fresh(tr)
    consumed = []

    def gen():
        for i in range(6):
            if i == 2:
                with torch.no_grad():
                    tr.optimizer.params[0].mul_(float('nan'))
            consumed.append(i)
            yield batches[i % len(batches)]

    with pytest.raises(RuntimeError, match='NaN model parameter'):
        tr.run_epoch(0, 'train', gen(), num_steps=6)
    assert consumed == [0, 1, 2, 3] and tr.step_count == 4
    assert all(bool(torch.isfinite(p).all()) for p in tr.optimizer.params[1:])


def test_guard_skips_non_finite_gradient(guard_setup):
    tr, batches = guard_setup
    errors = _fresh(tr)
    tr.run_epoch(0, 'train', iter(batches[:1]))
    before = [p.detach().clone() for p in tr.optimizer.params]
    count = int(tr.optimizer.count)
    bad = dict(batches[1], pcl_input=np.full_like(batches[1]['pcl_input'], np.nan))
    tr.run_epoch(0, 'train', iter([bad]))
    assert any('NaN/Inf gradient' in e for e in errors), errors
    assert all(torch.equal(p, q) for p, q in zip(tr.optimizer.params, before))
    assert int(tr.optimizer.count) == count
    tr.run_epoch(0, 'train', iter(batches[2:3]))
    assert int(tr.optimizer.count) == count + 1


# ------------------------------------------------------------------ (7) --

def test_convergence_recipe_with_torch_driver(tmp_path):
    art = json.load(open(_ARTIFACT))
    data_root = str(tmp_path / 'data')
    synthetic.make_greater_dataset(data_root, **dict(art['gen'],
                                                     stages=tuple(art['gen']['stages'])))
    base = list(art['argv']) + ['--device', 'cpu', '--data_path', data_root,
                                '--checkpoint_root', str(tmp_path / 'ck')]
    cfg = train_args(base + ['--name', 'conv', '--log_root', str(tmp_path / 'logs')])
    tr = t_train.main(cfg)
    spe = art['steps_per_epoch']
    assert tr.step_count == art['num_epochs'] * spe
    # LR milestones (2/5, 3/5, 4/5 of the epochs), each epoch's last step's rate.
    lrs = [float(tr.optimizer.lr(torch.tensor((e + 1) * spe - 1)))
           for e in range(art['num_epochs'])]
    for e in range(1, len(lrs)):
        gamma = art['lr_decay'] if e in art['lr_milestone_epochs'] else 1.0
        np.testing.assert_allclose(lrs[e], lrs[e - 1] * gamma, rtol=1e-6, err_msg=str(e))
    assert lrs[-1] < lrs[0]
    # Rolled checkpoints.
    names = set(os.listdir(cfg.output_path))
    assert names == set(art['checkpoints'])
    # Falling val loss.
    rows = _scalars(tr)
    vals = [rows[e]['val_aug/total_loss'] for e in range(art['num_epochs'])]
    assert all(np.isfinite(v) for v in vals), vals
    assert vals[-1] < vals[0] and min(vals[-3:]) < min(vals[:3]), vals
    # Resume from model_5 and run epoch 6: the unbroken run's losses.
    k = art['resume_check']['resume_epoch']
    rcfg = train_args(base + ['--name', 'conv_resume', '--log_root', str(tmp_path / 'logs2'),
                              '--resume', os.path.join(cfg.output_path, f'model_{k}.pkl')])
    logger = StepLogger(log_dir=None, context='resume', batch_size=rcfg.batch_size)
    _, train_loader, val_loader, _ = t_loader.create_train_val_loaders(rcfg, logger)
    rtr = t_train.Trainer(rcfg, 'greater', logger=logger)
    rtr.resume(rcfg.resume, steps_per_epoch=train_loader.steps_per_epoch)
    assert rtr.start_epoch == k + 1
    rtr.run_epoch(k + 1, 'train', train_loader.epoch(k + 1))
    rtr.run_epoch(k + 1, 'val_aug', val_loader.epoch(k + 1))
    logger.epoch_finished(k + 1)
    got = _scalars(rtr)[k + 1]
    for key in ('train/total_loss', 'val_aug/total_loss'):
        np.testing.assert_allclose(got[key], rows[k + 1][key], rtol=1e-4, err_msg=key)


# ------------------------------------------------------------------ (8) --

_BLOCK = ("import sys\n"
          "for m in ('jax', 'jaxlib', 'flax', 'optax', 'occlusions4d_tpu'):\n"
          "    sys.modules[m] = None\n")


def test_command_line_trains_and_evaluates_without_jax(data, tmp_path):
    '''python -m occlusions4d_torch.train --device cpu (run through runpy,
    which is what -m does, after blocking the JAX packages), then its
    checkpoint through the port's eval driver in another process.'''
    ck, logs = str(tmp_path / 'ck'), str(tmp_path / 'logs')
    argv = _argv(dict(_TINY, num_epochs=1, use_data_frac=0.01)) + [
        '--device', 'cpu', '--data_path', data['greater'], '--name', 'cli',
        '--checkpoint_root', ck, '--log_root', logs, '--viz_interval', '1']
    code = _BLOCK + (
        "import runpy\n"
        f"sys.argv = ['occlusions4d_torch.train'] + {argv!r}\n"
        "runpy.run_module('occlusions4d_torch.train', run_name='__main__', alter_sys=True)\n"
        "assert not any(sys.modules.get(m) for m in ('jax', 'flax', 'optax',\n"
        "                                            'occlusions4d_tpu'))\n"
        "print('trained')\n")
    res = subprocess.run([sys.executable, '-c', code], cwd=_ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and 'trained' in res.stdout, res.stderr[-3000:]
    (run,) = os.listdir(ck)
    assert sorted(os.listdir(os.path.join(ck, run))) == ['checkpoint.pkl', 'model_0.pkl']
    exported = os.listdir(os.path.join(logs, run, 'numpy'))
    assert any(fn.startswith('train_layer_coords_0_e0') for fn in exported), exported
    eval_argv = ['--resume', os.path.join(ck, run), '--data_path', data['greater'],
                 '--num_workers', '0', '--use_data_frac', '0.02', '--num_sample', '2048',
                 '--implicit_batch_size', '1024', '--save_metrics', 'true',
                 '--log_path', os.path.join(str(tmp_path), 'eval', 'run')]
    code = _BLOCK + (
        "from occlusions4d_torch.config import test_args\n"
        "from occlusions4d_torch.evaluate import test_driver\n"
        f"summary = test_driver.main(test_args({eval_argv!r}), device='cpu')\n"
        "assert summary['per_frame'] and not any(sys.modules.get(m) for m in\n"
        "                                        ('jax', 'flax', 'optax'))\n"
        "print('evaluated', len(summary['per_frame']))\n")
    res = subprocess.run([sys.executable, '-c', code], cwd=_ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and 'evaluated' in res.stdout, res.stderr[-3000:]
