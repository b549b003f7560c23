'''
Data-parallel training and query-sharded eval (occlusions4d_torch.parallel,
Trainer(..., group), train.main with --data_parallel, InferenceEngine with
query_parallel) held against the JAX package's sharded step and sharded
decode and against the one-process port, on the CPU: 2 ranks spawned over
gloo (a file:// rendezvous under tmp_path, so parallel test workers never
share a port), the lockstep's tiny model (tests/test_torch_train_driver.py),
the ranks' functions in tests/torch_parallel_ranks.py.
  (1) 3 train steps of batch 4 over 2 ranks across an LR boundary against
      the JAX Trainer with data_parallel=2 (2 of the 8 forced CPU devices):
      samplers fixed and FPS from point 0, every logged scalar within rtol
      2e-4 / atol 2e-5, parameter deltas within 5e-4 relative L2 (the
      lockstep tolerances);
  (2) the same run against the one-process port on the same global
      batches: logged scalars rtol 1e-5, parameter deltas 1e-4 relative L2
      (sum order only: measured 3.5e-7 and 4.3e-5);
  (3) a batch whose frames' ok flags differ between the ranks' halves: the
      2-rank losses and gradients equal the one-process ones (losses rtol
      1e-6, gradients 1e-5 relative L2; measured 1.9e-7); averaging the
      ranks' own means misses that gate (measured 8.9e-3);
  (4) batch norm, one step from each of 3 JAX states: the 2-rank step
      against the one-process port (losses rtol 1e-5, the running
      statistics rtol 1e-5, the deltas 1e-4) and against the JAX dp=2 and
      one-device steps (the lockstep tolerances, the statistics 1e-5, of
      the nearer; the two JAX steps part at some states, and the farther is
      held within 1.5 times their distance), the rounding-noise parameters
      of tests/test_torch_batchnorm.py left out of the deltas;
      the gradients of a forward-only all-reduce of the statistics miss the
      gate (1e-5 relative L2) that the autograd one meets (measured 0.78
      and 6.8e-7);
  (5) the rows the ranks receive, joined, are the one-process loader's
      batches bit for bit over 2 epochs with sample_bias counters on; a batch
      that fails on one rank alone is skipped by both, and the epoch ends;
  (6) a 2-rank train._run writes each checkpoint once (rank 0), which loads
      in the JAX load_models (params bit-equal) and resumes in a one-process
      port run; a 2-rank run resumed from model_0 equals the unbroken one
      bit for bit, and so does the run with rank 0's loaders on fork
      workers (--worker_mode process);
  (7) InferenceEngine(query_parallel=2) over two CPU replicas equals
      query_parallel=1 bit for bit (1200 queries, chunk 512, and 511 rounded
      to 510 against one device's launches of the same 255 rows: the CPU's
      products round the rows past a multiple of 8 by the launch's row
      count; the tail chunk's empty slice), and the JAX engine on the 8
      forced devices within 1e-5 (tests/test_evaluate.py's gate);
  (8) python -m occlusions4d_torch.train --device cpu --data_parallel 2 in a
      subprocess with the JAX packages blocked, its checkpoint evaluated by
      the eval driver with --query_parallel 2 in another;
  (9) the kernel build's temporaries are per process: two processes
      building at once against a stub compiler both succeed;
  (10) the device lists: --data_parallel / --query_parallel above the
      visible cards raise as the JAX make_mesh assert does; -1 resolves as
      the JAX Trainer resolves it; a batch that does not divide raises.
'''

import copy
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from occlusions4d_tpu import checkpoint as j_ckpt
from occlusions4d_tpu import train as j_train
from occlusions4d_tpu.config import train_args as j_train_args
from occlusions4d_tpu.data import loader as j_loader
from occlusions4d_tpu.evaluate.inference import InferenceEngine as JEngine
from occlusions4d_tpu.evaluate.inference import load_models as j_load_models
from occlusions4d_tpu.parallel import replicated, shard_batch
from occlusions4d_tpu.utils.logvis import StepLogger as JStepLogger
from occlusions4d_torch import parallel
from occlusions4d_torch import train as t_train
from occlusions4d_torch.checkpoint import from_jax_params
from occlusions4d_torch.config import train_args
from occlusions4d_torch.data import loader as t_loader
from occlusions4d_torch.data import synthetic
from occlusions4d_torch.evaluate.inference import InferenceEngine, load_models
from occlusions4d_torch.utils.logvis import StepLogger
from test_torch_train import _JFixedSampler, _supervision
from test_torch_train_driver import _BLOCK, _TINY, _argv, _no_random_fps
import torch_parallel_ranks as ranks

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CPU2 = ['cpu', 'cpu']
_TIMEOUT = 150            # seconds a spawned pair may take before it is killed.
_DP = dict(_TINY, batch_size=4, data_parallel=2)


def _dp_argv(root, out, **over):
    return _argv(dict(_DP, **over)) + ['--data_path', root, '--output_path', out]


def _spawn(fn, spec, tmp):
    spec = dict(spec, out=str(tmp / f'{fn.__name__}.pkl'))
    parallel.spawn(fn, _CPU2, args=(spec,), run_dir=str(tmp), timeout=_TIMEOUT)
    with open(spec['out'], 'rb') as f:
        return pickle.load(f)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _named(tr):
    return {f'{net}.{k}': v.detach().numpy().copy() for net, m in tr._nets.items()
            for k, v in m.state_dict().items()}


def _params_only(tr, state):
    names = {f'{net}.{n}' for net, m in tr._nets.items() for n, _ in m.named_parameters()}
    return {k: v for k, v in state.items() if k in names}


def _rel_delta(cur, ref, init, skip=()):
    keys = [k for k in cur if k not in skip]
    dc = np.concatenate([(cur[k] - init[k]).ravel() for k in keys])
    dr = np.concatenate([(ref[k] - init[k]).ravel() for k in keys])
    return float(np.linalg.norm(dc - dr) / np.linalg.norm(dc))


def _jax_named(jparams, tr):
    out = {}
    for net, mod in tr._nets.items():
        for k, v in from_jax_params(jax.tree_util.tree_map(np.asarray, jparams[net]),
                                    mod).items():
            out[f'{net}.{k}'] = v.numpy()
    return out


def _port_trainer(argv, name):
    cfg = train_args(argv)
    cfg.output_path, cfg.device = '', 'cpu'
    return t_train.Trainer(cfg, 'greater', logger=StepLogger(context=name))


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp('parallel')
    g = str(base / 'greater')
    synthetic.make_greater_dataset(g, num_scenes=2, num_views=2, num_frames=14,
                                   image_size=28, stages=('train', 'val', 'test'))
    return dict(greater=g, base=base)


# ------------------------------------------------------------- (1) - (3) --

@pytest.fixture(scope='module')
def dp_lockstep(data, tmp_path_factory):
    '''The JAX Trainer with data_parallel=2 over 3 steps (num_epochs 3, 2
    steps an epoch: the LR boundary at step 2), its checkpoint; the 2-rank
    port run; the one-process port run on the same batches.'''
    tmp = tmp_path_factory.mktemp('dp_lock')
    mp = pytest.MonkeyPatch()
    _no_random_fps(mp)
    mp.setattr(j_train, 'LOG_EVERY', 1)
    mp.setattr(t_train, 'LOG_EVERY', 1)
    argv = _dp_argv(data['greater'], str(tmp / 'jax_ck'), num_epochs=3, lr_decay=0.5)
    cfg = j_train_args(argv)
    _, loader, _, _ = j_loader.create_train_val_loaders(cfg, JStepLogger(context='j'))
    batches = list(loader.epoch(0))
    batches = [batches[i % len(batches)] for i in range(3)]
    rng = np.random.RandomState(3)
    for b in batches:
        b['pcl_input'] = b['pcl_input'].copy()
        b['pcl_input'][..., :3] = rng.rand(*b['pcl_input'].shape[:2], 3) * 4.0 - 2.0
    sup = _supervision(2, 96, 13)
    jtr = j_train.Trainer(cfg, 'greater', logger=JStepLogger(context='jdp'))
    assert jtr.mesh.devices.size == 2
    jtr.init_state(batches[0], steps_per_epoch=2)
    jtr.pipeline.sampler = _JFixedSampler(*sup, 48)
    init = jax.tree_util.tree_map(np.asarray, jtr.state['params'])
    jhist, jparams = [], []
    for epoch, sl in ((0, slice(0, 2)), (1, slice(2, 3))):
        jhist.append(jtr.run_epoch(epoch, 'train', iter(batches[sl])))
        jparams.append(jax.tree_util.tree_map(np.asarray, jtr.state['params']))
    jtr.save(1)
    # Frame 0 of global row 2 (rank 1's first) not ok: 4 ok frames on rank
    # 0, 3 on rank 1.
    uneven = dict(batches[0], valo_ids=batches[0]['valo_ids'].copy())
    uneven['valo_ids'][2, 0] = ranks.DROP
    spec = dict(argv=argv, init=init, sup=sup, batches=batches, uneven=uneven)
    dp = _spawn(ranks.lockstep_rank, spec, tmp)
    # The one-process port on the same global batches.
    tr = _port_trainer(argv, 'one')
    tr.init_state(params=init, steps_per_epoch=2)
    tr.pipeline.sampler = ranks.FixedSampler(*sup, 48)
    init_named = _named(tr)
    hist, params = [], []
    for epoch, sl in ((0, slice(0, 2)), (1, slice(2, 3))):
        hist.append(tr.run_epoch(epoch, 'train', iter(batches[sl])))
        params.append(_named(tr))
    tr.init_state(params=init, steps_per_epoch=2)
    tr.pipeline.sampler = ranks.FixedSampler(*sup, 48)
    grads, logged = ranks.flat_grads(tr, uneven, None)
    mp.undo()
    return dict(dp=dp, jhist=jhist, jparams=[_jax_named(p, tr) for p in jparams],
                hist=hist, params=params, grads=grads, logged=logged, init=init_named,
                tr=tr, ckpt=os.path.join(str(tmp / 'jax_ck'), 'model_1.pkl'))


def _assert_scalars(got, ref, rtol, atol, what):
    assert len(got) == len(ref), what
    for i, (g, r) in enumerate(zip(got, ref)):
        for k in ('total_loss', 'loss_dens', 'loss_rgb', 'loss_track', 'grad_norm'):
            np.testing.assert_allclose(float(g[k]), float(r[k]), rtol=rtol, atol=atol,
                                       err_msg=f'{what} step {i} {k}')


def test_dp_train_steps_lockstep_with_jax(dp_lockstep):
    lk = dp_lockstep
    dp, tr = lk['dp'], lk['tr']
    assert dp['steps'] == 3 and dp['lrs'] == [pytest.approx(1e-3)] * 2 + [
        pytest.approx(5e-4)]
    for epoch in (0, 1):
        _assert_scalars(dp['hist'][epoch], lk['jhist'][epoch], 2e-4, 2e-5, f'epoch {epoch}')
        assert all(bool(m['grads_finite']) and bool(m['sample_ok']) for m in dp['hist'][epoch])
        cur = _params_only(tr, dp['params'][epoch])
        rel = _rel_delta(cur, lk['jparams'][epoch], lk['init'])
        assert rel < 5e-4, (epoch, rel)


def test_dp_train_steps_match_one_process(dp_lockstep):
    lk = dp_lockstep
    dp, tr = lk['dp'], lk['tr']
    for epoch in (0, 1):
        _assert_scalars(dp['hist'][epoch], lk['hist'][epoch], 1e-5, 1e-7, f'epoch {epoch}')
        cur = _params_only(tr, dp['params'][epoch])
        rel = _rel_delta(cur, lk['params'][epoch], lk['init'])
        assert rel < 1e-4, (epoch, rel)


def test_dp_unequal_ok_counts_match_one_process(dp_lockstep):
    '''The weighted mean's denominator is the global ok count: per-rank means
    (each rank dividing by its own, then averaged) miss the gate.'''
    lk = dp_lockstep
    dp = lk['dp']
    assert dp['ok_per_rank'] == [2, 1]       # examples whose frame 0 is ok.
    for k, v in lk['logged'].items():
        np.testing.assert_allclose(dp['logged'][k], v, rtol=1e-6, atol=1e-8, err_msg=k)
    assert _rel_l2(dp['grads'], lk['grads']) < 1e-5
    naive_gap = _rel_l2(dp['naive'], lk['grads'])
    assert naive_gap > 1e-3, naive_gap
    assert abs(dp['naive_logged']['dens'] - lk['logged']['dens']) > 1e-5 * abs(
        lk['logged']['dens'])


# --------------------------------------------------------------------- (4) --

@pytest.fixture(scope='module')
def dp_batchnorm(data, tmp_path_factory):
    '''The JAX Trainer with pt_norm_type 'batch' and data_parallel=2: its
    state before each of 3 steps saved as a pkl (the running statistics
    moved off their init), its metrics and parameters after each; the 2-rank
    port step from each state; the one-process port step from each.'''
    tmp = tmp_path_factory.mktemp('dp_bn')
    mp = pytest.MonkeyPatch()
    _no_random_fps(mp)
    argv = _dp_argv(data['greater'], str(tmp / 'states'), pt_norm_type='batch')
    cfg = j_train_args(argv)
    _, loader, _, _ = j_loader.create_train_val_loaders(cfg, JStepLogger(context='j'))
    batch = next(iter(loader.epoch(0)))
    rng = np.random.RandomState(4)
    batch['pcl_input'] = batch['pcl_input'].copy()
    batch['pcl_input'][..., :3] = rng.rand(*batch['pcl_input'].shape[:2], 3) * 4.0 - 2.0
    sup = _supervision(2, 96, 13)
    jtr = j_train.Trainer(cfg, 'greater', logger=JStepLogger(context='jbn'))
    jtr.init_state(batch, steps_per_epoch=1000)
    jtr.pipeline.sampler = _JFixedSampler(*sup, 48)
    state = jax.tree_util.tree_map(np.asarray, jtr.state)
    state['params']['encoder']['batch_stats'] = jax.tree_util.tree_map(
        lambda a: a + rng.rand(*a.shape).astype(np.float32),
        state['params']['encoder']['batch_stats'])
    jtr.state = jax.device_put(state, replicated(jtr.mesh))
    host = {k: v for k, v in batch.items() if k not in t_train._HOST_KEYS}
    paths, jsteps = [], []
    for i in range(3):
        jtr.save(i)
        paths.append(os.path.join(cfg.output_path, f'model_{i}.pkl'))
        jtr.state, jm = jtr._train_step(jtr.state, shard_batch(host, jtr.mesh),
                                        jax.random.PRNGKey(i))
        jsteps.append(dict(metrics=jax.tree_util.tree_map(np.asarray, jm),
                           params=jax.tree_util.tree_map(np.asarray, jtr.state['params'])))
    # JAX's one-device step from the same states: how far its own sharding
    # moves the sharded step.
    j1 = j_train.Trainer(j_train_args(argv + ['--data_parallel', '1']), 'greater',
                         logger=JStepLogger(context='jbn1'))
    j1.tx, j1.schedule = j_train.build_optimizer(j1.cfg, 1000)
    j1.pipeline.sampler = _JFixedSampler(*sup, 48)
    for i, (step, path) in enumerate(zip(jsteps, paths)):
        j1.state = jax.device_put(j_ckpt.load_checkpoint(path)['state'],
                                  replicated(j1.mesh))
        if i == 0:
            j1._build_steps()
        j1.state, jm = j1._train_step(j1.state, shard_batch(host, j1.mesh),
                                      jax.random.PRNGKey(0))
        step['one_device'] = dict(
            metrics=jax.tree_util.tree_map(np.asarray, jm),
            params=jax.tree_util.tree_map(np.asarray, j1.state['params']))
    host['meta_data'] = batch['meta_data']
    dp = _spawn(ranks.batchnorm_rank, dict(argv=argv, batch=host, sup=sup, states=paths),
                tmp)
    tr = _port_trainer(argv, 'bn_one')
    one = []
    for path in paths:
        tr.resume(path, steps_per_epoch=1000)
        tr.pipeline.sampler = ranks.FixedSampler(*sup, 48)
        before = _named(tr)
        m = tr.step(host)
        one.append(dict(metrics={k: t_train._numpy(v) for k, v in m.items()},
                        state=_named(tr), before=before))
    # The rounding-noise parameters of each state (tests/test_torch_batchnorm.py):
    # zero gradients but for rounding, which AdamW turns into lr-size moves.
    noise = []
    for path in paths:
        tr.resume(path, steps_per_epoch=1000)
        tr.pipeline.sampler = ranks.FixedSampler(*sup, 48)
        g, _ = ranks.flat_grads(tr, host, None)
        grads = g if not noise else grads
        noise.append(_noise_params(tr, g))
    mp.undo()
    return dict(dp=dp, one=one, jsteps=jsteps, grads=grads, noise=noise, tr=tr)


def _noise_params(tr, grads):
    out, i = set(), 0
    scale = float(np.abs(grads).max())
    for net, m in tr._nets.items():
        for n, p in m.named_parameters():
            if float(np.abs(grads[i:i + p.numel()]).max()) < 1e-5 * scale:
                out.add(f'{net}.{n}')
            i += p.numel()
    return out


def _stats(state):
    return {k: v for k, v in state.items() if k.endswith(('running_mean', 'running_var'))}


def test_dp_batch_norm_matches_one_process_and_jax(dp_batchnorm):
    '''Each step against the one-process port (tight: sum order only), and
    against JAX's dp=2 step and its one-device step from the same state. The
    two JAX steps themselves part at some states (by 2.6e-3 relative L2 in
    the deltas of the decoder's attention weights, measured: a discrete
    choice that rounding moves), and the port's step is then one of them: it
    is held within the lockstep tolerances of the nearer JAX step and within
    1.5 times the two JAX steps' own distance of the farther.'''
    lk = dp_batchnorm
    tr = lk['tr']
    assert len(_stats(lk['one'][0]['state'])) == 4

    def near_far(d1, d2, spread, gate):
        assert min(d1, d2) <= gate and max(d1, d2) <= max(gate, 1.5 * spread), (
            d1, d2, spread, gate)

    for i, (dp, one, js, noise) in enumerate(zip(lk['dp']['steps'], lk['one'], lk['jsteps'],
                                                 lk['noise'])):
        assert noise
        init = _params_only(tr, one['before'])
        cur = _params_only(tr, dp['state'])
        j2 = _jax_named(js['params'], tr)
        j1 = _jax_named(js['one_device']['params'], tr)
        for k in ('total_loss', 'loss_dens', 'loss_rgb', 'loss_track', 'grad_norm'):
            got, j2k = float(dp['metrics'][k]), float(js['metrics'][k])
            j1k = float(js['one_device']['metrics'][k])
            np.testing.assert_allclose(got, float(one['metrics'][k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f'step {i} {k}')
            near_far(abs(got - j1k), abs(got - j2k), abs(j1k - j2k),
                     2e-4 * abs(j2k) + 2e-5)
        assert bool(dp['metrics']['grads_finite']) and bool(dp['metrics']['params_finite'])
        assert _rel_delta(cur, _params_only(tr, one['state']), init, noise) < 1e-4, i
        p1, p2 = _params_only(tr, j1), _params_only(tr, j2)
        near_far(_rel_delta(cur, p1, init, noise), _rel_delta(cur, p2, init, noise),
                 _rel_delta(p1, p2, init, noise), 5e-4)
        for k, v in _stats(dp['state']).items():
            assert not np.array_equal(v, one['before'][k]), k     # they move.
            np.testing.assert_allclose(v, one['state'][k], rtol=1e-5, atol=1e-7,
                                       err_msg=f'step {i} {k}')
            near_far(float(np.max(np.abs(v - j1[k]) / (np.abs(j1[k]) + 1e-2))),
                     float(np.max(np.abs(v - j2[k]) / (np.abs(j2[k]) + 1e-2))),
                     float(np.max(np.abs(j1[k] - j2[k]) / (np.abs(j2[k]) + 1e-2))), 1e-5)


def test_dp_batch_norm_forward_only_all_reduce_misses_gate(dp_batchnorm):
    '''The statistics' gradients all-reduced in the backward (AllReduceSum)
    give the one-process gradients; a forward-only sum leaves each rank the
    gradient of its own rows and misses the gate.'''
    lk = dp_batchnorm
    assert _rel_l2(lk['dp']['grads'], lk['grads']) < 1e-5
    gap = _rel_l2(lk['dp']['fwd_only'], lk['grads'])
    assert gap > 1e-3, gap


# ------------------------------------------------------------- (5) - (6) --

@pytest.fixture(scope='module')
def dp_data(data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp('dp_data')
    loader_argv = _argv(dict(_DP, num_workers=0, sample_bias='occl')) + [
        '--data_path', data['greater'], '--output_path', '']
    cfg = train_args(loader_argv)
    _, loader, _, _ = t_loader.create_train_val_loaders(cfg, StepLogger(context='ref'))
    ref = [list(loader.epoch(e)) for e in (0, 1)]
    run_argv = _argv(dict(_DP, num_epochs=2, use_data_frac=0.02)) + [
        '--device', 'cpu', '--data_path', data['greater'], '--name', 'dprun',
        '--checkpoint_root', str(tmp / 'ck'), '--log_root', str(tmp / 'logs')]
    spec = dict(argv=_dp_argv(data['greater'], ''), loader_argv=loader_argv,
                err_batches=[ref[0][i % len(ref[0])] for i in range(3)], run_argv=run_argv,
                resumed_out=str(tmp / 'resumed'), process_out=str(tmp / 'process'))
    out = _spawn(ranks.data_rank, spec, tmp)
    return dict(out=out, ref=ref, run_cfg=train_args(run_argv), tmp=tmp)


def test_dp_global_batch_rows_equal_one_process(dp_data):
    rows, ref = dp_data['out']['rows'], dp_data['ref']
    for e in (0, 1):
        assert len(rows[0][e]) == len(rows[1][e]) == len(ref[e]) >= 1
        for r0, r1, g in zip(rows[0][e], rows[1][e], ref[e]):
            assert sorted(r0) == sorted(g)
            for k, v in g.items():
                if k == 'meta_data':         # passed through whole, as in JAX.
                    for m0, m1, mg in zip(r0[k], r1[k], v):
                        assert all(np.array_equal(np.asarray(m0[n]), np.asarray(mg[n]))
                                   and np.array_equal(np.asarray(m1[n]), np.asarray(mg[n]))
                                   for n in mg)
                    assert len(r0[k]) == len(r1[k]) == len(v) == 4
                    continue
                joined = np.concatenate([r0[k], r1[k]])
                assert joined.dtype == v.dtype and np.array_equal(joined, v), (e, k)


def test_dp_data_error_skipped_on_every_rank(dp_data):
    '''Batch 1 fails on rank 1 only: both ranks log an error, skip it and
    run the other two steps (the spawn's timeout would catch a hang).'''
    err = dp_data['out']['err']
    assert [r['steps'] for r in err] == [2, 2]
    assert len(err[0]['errors']) == len(err[1]['errors']) == 1
    assert 'another rank' in err[0]['errors'][0]
    assert 'on rank 1' in err[1]['errors'][0]


def test_dp_checkpoint_loads_in_jax_and_resumes_in_port(dp_data):
    out, cfg = dp_data['out'], dp_data['run_cfg']
    assert out['saves'] == [[0, 1, 1], []]         # rank 0 writes; resumed: epoch 1.
    assert sorted(os.listdir(cfg.output_path)) == ['checkpoint.pkl', 'model_0.pkl',
                                                    'model_1.pkl']
    full = out['full']
    loaded = j_load_models(os.path.join(cfg.output_path, 'model_1.pkl'))
    assert loaded['epoch'] == 1
    cfg1 = copy.copy(cfg)
    cfg1.device, cfg1.output_path = 'cpu', ''
    tr = t_train.Trainer(cfg1, 'greater', logger=StepLogger(context='one'))
    tr.resume(os.path.join(cfg.output_path, 'checkpoint.pkl'), steps_per_epoch=1)
    ref = _jax_named(loaded['params'], tr)
    assert all(np.array_equal(full['state'][k], ref[k]) for k in ref)
    assert tr.start_epoch == 2 and int(tr.optimizer.count) == full['count']
    got = _named(tr)
    assert all(np.array_equal(got[k], v) for k, v in full['state'].items())
    assert all(np.array_equal(m.numpy(), v) for m, v in zip(tr.optimizer.mu, full['mu']))
    assert all(np.array_equal(m.numpy(), v) for m, v in zip(tr.optimizer.nu, full['nu']))


def test_dp_resumed_run_equals_unbroken(dp_data):
    full, res = dp_data['out']['full'], dp_data['out']['resumed']
    assert res['start_epoch'] == 1 and res['step_count'] == full['step_count']
    assert res['count'] == full['count'] > 0
    assert all(np.array_equal(res['state'][k], v) for k, v in full['state'].items())
    assert all(np.array_equal(a, b) for a, b in zip(res['mu'], full['mu']))
    assert all(np.array_equal(a, b) for a, b in zip(res['nu'], full['nu']))
    last = {k: v for k, v in full['scalars'][-1].items() if k.endswith('total_loss')}
    assert last and last == {k: v for k, v in res['scalars'][-1].items()
                             if k.endswith('total_loss')}


def test_dp_process_workers_equal_thread_workers(dp_data):
    '''The 2-rank run with rank 0's loaders on fork workers (forked in a
    spawned rank, before its Trainer) equals the unbroken run bit for bit.'''
    full, proc = dp_data['out']['full'], dp_data['out']['process']
    assert proc['step_count'] == full['step_count'] > 0
    assert proc['count'] == full['count']
    assert all(np.array_equal(proc['state'][k], v) for k, v in full['state'].items())
    assert all(np.array_equal(a, b) for a, b in zip(proc['mu'], full['mu']))
    losses = [{k: v for k, v in e.items() if k.endswith('loss')} for e in full['scalars']]
    assert losses and all(losses) and losses == [
        {k: v for k, v in e.items() if k.endswith('loss')} for e in proc['scalars']]


# --------------------------------------------------------------------- (7) --

_ENGINE = dict(color_mode='rgb_nosigmoid', predict_segmentation=False, semantic_classes=13,
               track_mode='none')


@pytest.mark.parametrize('chunk', [512, 511])
def test_query_parallel_decode_bit_equal_one_device(dp_lockstep, chunk):
    '''Chunk 512: each device decodes 256 queries of a chunk, the tail chunk
    (176) on the first device alone, bit-equal to one device's 512. Chunk
    511 rounds to 510: bit-equal to one device decoding the same 255-query
    launches; one device's 511-query launches differ in the last bits (the
    CPU's matrix products round rows past a multiple of 8 apart), within
    1e-6.'''
    loaded = load_models(dp_lockstep['ckpt'], device='cpu')
    eng2 = InferenceEngine(loaded, implicit_batch_size=chunk, query_parallel=2, **_ENGINE)
    assert len(eng2.devices) == 2 and eng2.chunk == chunk // 2 * 2
    assert eng2.decoders[1] is not eng2.decoder
    rng = np.random.RandomState(4)
    pcl = rng.rand(256, 8).astype(np.float32) * 2 - 1
    queries = (rng.rand(1200, 4) * 4 - 2).astype(np.float32)
    a2, g2 = eng2.encode(pcl)
    out2 = eng2.decode_all(queries, a2, g2)
    outs = {}
    for c in {chunk, eng2.chunk // 2}:
        eng1 = InferenceEngine(loaded, implicit_batch_size=c, query_parallel=1, **_ENGINE)
        a1, g1 = eng1.encode(pcl)
        assert torch.equal(a1, a2) and torch.equal(g1, g2)
        outs[c] = eng1.decode_all(queries, a1, g1)
    assert out2.shape == (1200, 5) and np.array_equal(out2, outs[eng2.chunk // 2])
    np.testing.assert_allclose(out2, outs[chunk], atol=1e-6, rtol=0)
    if chunk == 512:
        assert np.array_equal(out2, outs[chunk])


def test_query_parallel_decode_matches_jax_8_devices(dp_lockstep):
    path = dp_lockstep['ckpt']
    jeng = JEngine(j_load_models(path), implicit_batch_size=512, query_parallel=-1,
                   **_ENGINE)
    assert jeng.mesh.devices.size == 8
    eng = InferenceEngine(load_models(path, device='cpu'), implicit_batch_size=512,
                          query_parallel=2, **_ENGINE)
    rng = np.random.RandomState(4)
    pcl = rng.rand(256, 8).astype(np.float32) * 2 - 1
    queries = (rng.rand(1200, 4) * 4 - 2).astype(np.float32)
    ja, jg = jeng.encode(pcl)
    ref = jeng.decode_all(queries, ja, jg)
    a, g = eng.encode(pcl)
    np.testing.assert_allclose(eng.decode_all(queries, a, g), ref, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------- (8) --

def test_command_line_data_parallel_and_query_parallel_without_jax(data, tmp_path):
    ck, logs = str(tmp_path / 'ck'), str(tmp_path / 'logs')
    argv = _argv(dict(_TINY, num_epochs=1, use_data_frac=0.01, data_parallel=2)) + [
        '--device', 'cpu', '--data_path', data['greater'], '--name', 'dpcli',
        '--checkpoint_root', ck, '--log_root', logs]
    code = _BLOCK + textwrap.dedent(f'''\
        import runpy
        sys.argv = ['occlusions4d_torch.train'] + {argv!r}
        runpy.run_module('occlusions4d_torch.train', run_name='__main__', alter_sys=True)
        assert not any(sys.modules.get(m) for m in ('jax', 'flax', 'optax',
                                                    'occlusions4d_tpu'))
        print('trained')
        ''')
    res = subprocess.run([sys.executable, '-c', code], cwd=_ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and 'trained' in res.stdout, res.stderr[-3000:]
    (run,) = os.listdir(ck)
    assert sorted(os.listdir(os.path.join(ck, run))) == ['checkpoint.pkl', 'model_0.pkl']
    eval_argv = ['--resume', os.path.join(ck, run), '--data_path', data['greater'],
                 '--num_workers', '0', '--use_data_frac', '0.02', '--num_sample', '2048',
                 '--implicit_batch_size', '1024', '--save_metrics', 'true',
                 '--query_parallel', '2', '--log_path', str(tmp_path / 'eval' / 'run')]
    code = _BLOCK + textwrap.dedent(f'''\
        from occlusions4d_torch.config import test_args
        from occlusions4d_torch.evaluate import test_driver
        args = test_args({eval_argv!r})
        assert args.query_parallel == 2
        summary = test_driver.main(args, device='cpu')
        assert summary['per_frame'] and not any(sys.modules.get(m) for m in
                                                ('jax', 'flax', 'optax'))
        print('evaluated', len(summary['per_frame']))
        ''')
    res = subprocess.run([sys.executable, '-c', code], cwd=_ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and 'evaluated' in res.stdout, res.stderr[-3000:]
    assert "devices ['cpu', 'cpu']" in res.stdout


# --------------------------------------------------------------------- (9) --

_STUB_NVCC = '''#!{python}
import sys, time
out = sys.argv[sys.argv.index('-o') + 1]
with open(out, 'w') as f:
    f.write('head ')
time.sleep(0.5)
with open(out, 'a') as f:
    f.write('tail')
'''


def test_build_temporaries_are_per_process(tmp_path):
    '''Two processes build every library at once (data-parallel ranks on a
    fresh tree): each compiles into a temporary of its own and moves it into
    place, so both succeed and every library is whole.'''
    bin_dir, build = tmp_path / 'bin', tmp_path / 'build'
    bin_dir.mkdir()
    build.mkdir()
    nvcc = bin_dir / 'nvcc'
    nvcc.write_text(_STUB_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    code = textwrap.dedent(f'''\
        import os
        os.environ['PATH'] = {str(bin_dir)!r} + os.pathsep + os.environ['PATH']
        from occlusions4d_torch.ops import _build
        _build._build_dir = lambda: {str(build)!r}
        print(sorted(_build.build_all()))
        ''')
    procs = [subprocess.Popen([sys.executable, '-c', code], cwd=_ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    from occlusions4d_torch.ops import _build
    names = sorted(os.listdir(build))
    assert len(names) == len(_build.SOURCES), names
    assert all((build / n).read_text() == 'head tail' for n in names)


# -------------------------------------------------------------------- (10) --

def test_device_lists_and_data_parallel_resolution(tmp_path):
    n_cards = torch.cuda.device_count()
    with pytest.raises(AssertionError, match=f'{n_cards + 1} > {n_cards} available'):
        parallel.local_devices(n_cards + 1, 'cuda')
    assert parallel.local_devices(3, 'cpu') == [torch.device('cpu')] * 3
    assert parallel.local_devices(-1, 'cpu') == [torch.device('cpu')]
    # -1: the largest divisor of the batch that the host holds (one CPU).
    assert parallel.resolve_data_parallel(-1, 4, 'cpu') == [torch.device('cpu')]
    assert len(parallel.resolve_data_parallel(2, 4, 'cpu')) == 2
    assert len(parallel.resolve_data_parallel(3, 4, 'cpu')) == 3
    with pytest.raises(ValueError, match='not divisible'):
        t_train.Trainer(train_args(_argv(_TINY) + ['--checkpoint_root', str(tmp_path)]),
                        group=parallel.Group(0, 3, torch.device('cpu'), 'gloo'))
    argv = _argv(dict(_TINY, batch_size=3)) + ['--checkpoint_root', str(tmp_path)]
    with pytest.raises(ValueError, match='not divisible'):
        train_args(argv + ['--data_parallel', '2'])
    assert train_args(argv + ['--data_parallel', '3']).data_parallel == 3
    cfg = train_args(argv + ['--data_parallel', str(n_cards + 1), '--batch_size',
                             str(n_cards + 1)])
    with pytest.raises(AssertionError, match='available'):
        t_train.main(cfg)
    with pytest.raises(AssertionError, match='available'):
        InferenceEngine(dict(encoder=None, decoder=None, device=torch.device('cuda')),
                        query_parallel=n_cards + 1, **_ENGINE)
    assert parallel.shard_rows({'a': np.arange(4), 'meta_data': [1, 2, 3, 4],
                                's': np.float32(2)}, 1, 2)['a'].tolist() == [2, 3]


