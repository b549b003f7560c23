'''
Reference-layout .pth checkpoints in the port (checkpoint.load_reference_
checkpoint, the directory arbitration, evaluate.load_models and
Trainer.resume), held against the JAX package on the CPU with a .pth written
here: a flax init of both networks of a tiny configuration through the JAX
package's export_torch_state_dict, the decoder's block under its legacy
'pt_block.' name, saved with torch.save in the reference dict's layout
(pcl_net, implicit_net, pcl_args, implicit_args, dset_args, args as an
argparse.Namespace, epoch, and the optimizer, lr_scheduler and scaler state
dicts of torch's Adam, MultiStepLR and GradScaler):
  * both packages' load_reference_checkpoint give the same variables, bit
    for bit, and the same args and epoch;
  * both load_models give networks whose state dicts agree bit for bit
    (the port's loaded with strict=True) and dense outputs on one small
    scene within 1e-5 (the JAX engine in precision 'highest', the port's
    plain versions);
  * a file holding a global outside the reference dict's own is refused,
    the global named;
  * a run directory resolves to its pkl, else to its .pth, and refuses an
    orbax epoch;
  * a 2-step warm start from the .pth (Trainer.resume) steps in lockstep
    with the JAX Trainer.resume of the same file at the lockstep tolerances
    of tests/test_torch_train_driver.py, with equal step counts.
'''

import argparse
import collections
import fractions
import os

import jax
import numpy as np
import pytest
import torch

# Six test workers share eight cores: keep PyTorch's CPU pool small.
torch.set_num_threads(2)

from occlusions4d_tpu import checkpoint as j_ckpt
from occlusions4d_tpu import train as j_train
from occlusions4d_tpu.config import train_args as j_train_args
from occlusions4d_tpu.data import loader as j_loader
from occlusions4d_tpu.evaluate import inference as j_inf
from occlusions4d_tpu.utils.logvis import StepLogger as JStepLogger
from occlusions4d_torch import checkpoint as t_ckpt
from occlusions4d_torch import train as t_train
from occlusions4d_torch.config import train_args
from occlusions4d_torch.evaluate import inference as t_inf
from occlusions4d_torch.utils.logvis import StepLogger
from test_torch_train import _JFixedSampler, _supervision, _TFixedSampler
from test_torch_train_driver import (_STEPS, _TINY, _argv, _assert_logged_close,
                                     _no_random_fps, _rel_delta, _named, data)  # noqa: F401

_EPOCH = 3
_PTH_TINY = dict(_TINY, cross_attn_layers=1, cr_attn_type='c')


def _pth_argv(root, out):
    return _argv(dict(_PTH_TINY, num_epochs=20)) + ['--data_path', root,
                                                    '--output_path', out]


def _reference_dict(variables, cfg, encoder_args, decoder_args, dset_args):
    '''The reference train.py's torch.save dict of flax variables.'''
    pcl = {k: torch.tensor(np.array(v)) for k, v in
           j_ckpt.export_torch_state_dict(variables['encoder'], 'encoder').items()}
    dec = {k: torch.tensor(np.array(v)) for k, v in
           j_ckpt.export_torch_state_dict(variables['decoder'], 'decoder').items()}
    legacy = collections.OrderedDict(
        (k.replace('pt_blocks.0.', 'pt_block.', 1) if k.startswith('pt_blocks.0.') else k, v)
        for k, v in dec.items())
    assert any(k.startswith('pt_block.') for k in legacy)
    params = [torch.nn.Parameter(torch.ones(3))]
    opt = torch.optim.Adam(params, lr=1e-3)
    params[0].grad = torch.ones(3)
    opt.step()
    sched = torch.optim.lr_scheduler.MultiStepLR(opt, [8, 12, 16], 0.4)
    return dict(optimizer=opt.state_dict(), lr_scheduler=sched.state_dict(),
                scaler=torch.amp.GradScaler('cpu').state_dict(), epoch=_EPOCH,
                args=argparse.Namespace(**vars(cfg)),
                pcl_args=dict(encoder_args, mixed_precision=False),
                implicit_args=dict(decoder_args), dset_args=dict(dset_args),
                pcl_net=collections.OrderedDict(pcl), implicit_net=legacy)


@pytest.fixture(scope='module')
def pth(data, tmp_path_factory):
    '''A JAX Trainer's flax init of the tiny model written as a reference
    .pth, with the first loader batches (positions redrawn uniformly, as in
    the train driver's lockstep) for the warm start.'''
    mp = pytest.MonkeyPatch()
    _no_random_fps(mp)
    root = tmp_path_factory.mktemp('pth')
    cfg = j_train_args(_pth_argv(data['greater'], ''))
    _, loader, _, dset_args = j_loader.create_train_val_loaders(cfg, JStepLogger(context='j'))
    batches = list(loader.epoch(0))[:_STEPS]
    rng = np.random.RandomState(3)
    for b in batches:
        b['pcl_input'][..., :3] = rng.rand(*b['pcl_input'].shape[:2], 3) * 4.0 - 2.0
    jtr = j_train.Trainer(cfg, 'greater', logger=JStepLogger(context='jinit'))
    jtr.init_state(batches[0], steps_per_epoch=_STEPS)
    variables = jax.tree_util.tree_map(np.asarray, jtr.state['params'])
    mp.undo()
    path = str(root / 'weights.pth')
    torch.save(_reference_dict(variables, cfg, jtr.encoder_args, jtr.decoder_args,
                               dset_args), path)
    return dict(path=path, root=root, batches=batches, variables=variables,
                argv=_pth_argv(data['greater'], ''))


def _assert_trees_equal(a, b, where=''):
    assert sorted(a) == sorted(b), where
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f'{where}/{k}')
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, f'{where}/{k}'
            np.testing.assert_array_equal(x, y, err_msg=f'{where}/{k}')


def test_reference_pth_reads_alike_in_both_packages(pth):
    ref, mine = j_ckpt.load_reference_checkpoint(pth['path']), \
        t_ckpt.load_reference_checkpoint(pth['path'])
    assert set(ref) == set(mine)
    for key in ('encoder_variables', 'decoder_variables'):
        _assert_trees_equal(jax.tree_util.tree_map(np.asarray, ref[key]), mine[key], key)
    _assert_trees_equal(mine['encoder_variables'], pth['variables']['encoder'])
    _assert_trees_equal(mine['decoder_variables'], pth['variables']['decoder'])
    assert mine['epoch'] == ref['epoch'] == _EPOCH
    for key in ('pcl_args', 'implicit_args', 'dset_args'):
        assert mine[key] == ref[key], key
    assert isinstance(mine['train_args'], argparse.Namespace)
    assert vars(mine['train_args']) == vars(ref['train_args'])


def test_reference_pth_load_models_match_jax(pth):
    '''Both load_models on the .pth: the JAX package's fields, state dicts
    equal bit for bit, dense outputs within 1e-5.'''
    jl = j_inf.load_models(pth['path'])
    tl = t_inf.load_models(pth['path'], device='cpu', logger=None)
    assert tl['data_kind'] is None and jl['data_kind'] is None
    assert tl['epoch'] == jl['epoch'] == _EPOCH
    assert tl['encoder_args'] == jl['encoder_args']
    assert tl['encoder_args']['fps_random_start'] is False
    assert 'mixed_precision' not in tl['encoder_args']
    assert tl['decoder_args'] == jl['decoder_args'] and tl['dset_args'] == jl['dset_args']
    assert vars(tl['train_config']) == vars(jl['train_config'])
    for net, mod in (('encoder', tl['encoder']), ('decoder', tl['decoder'])):
        exported = j_ckpt.export_torch_state_dict(jl['params'][net], net)
        sd = mod.state_dict()
        assert sorted(exported) == sorted(sd) and not mod.training
        assert all(sd[k].dtype == torch.float32 for k in sd)
        assert all(np.array_equal(np.asarray(exported[k]), sd[k].numpy()) for k in sd), net
    cfg = tl['train_config']
    rng = np.random.RandomState(0)
    pcl = (rng.rand(256, 8) * 2 - 1).astype(np.float32)
    queries = (rng.rand(3000, 4) * 4 - 2).astype(np.float32)
    queries[:, 3] = 0.0
    outs = []
    for inf, loaded, kw in ((j_inf, jl, dict(precision='highest')), (t_inf, tl, {})):
        engine = inf.InferenceEngine(loaded, cfg.color_mode, False, cfg.semantic_classes,
                                     implicit_batch_size=1024, **kw)
        abstract, fg = engine.encode(pcl)
        outs.append(np.asarray(engine.decode_all(queries, abstract, fg)))
    assert outs[1].shape == outs[0].shape == (3000, 5) and np.isfinite(outs[1]).all()
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-5, rtol=0)


def test_reference_pth_with_a_foreign_global_is_refused(pth, tmp_path):
    ck = torch.load(pth['path'], weights_only=False)
    ck['args'].lr_fraction = fractions.Fraction(1, 3)
    bad = str(tmp_path / 'foreign.pth')
    torch.save(ck, bad)
    with pytest.raises(ValueError, match='fractions.Fraction'):
        t_ckpt.load_reference_checkpoint(bad)
    with pytest.raises(ValueError, match='fractions.Fraction'):
        t_inf.load_models(bad, device='cpu', logger=None)
    assert j_ckpt.load_reference_checkpoint(bad)['epoch'] == _EPOCH   # JAX unpickles all.


def test_checkpoint_directory_arbitration(pth, tmp_path):
    '''A run directory: its pkl epochs win, else its .pth; an orbax epoch
    newer than every pkl one (or the requested one) raises.'''
    run = tmp_path / 'run'
    run.mkdir()
    for name in ('checkpoint.pth', f'model_{_EPOCH}.pth'):
        os.link(pth['path'], run / name)
    assert t_ckpt.resolve_checkpoint_file(str(run)) == str(run / 'checkpoint.pth')
    assert t_ckpt.resolve_checkpoint_file(str(run), _EPOCH) == str(run / f'model_{_EPOCH}.pth')
    assert t_ckpt.resolve_checkpoint_file(pth['path']) == pth['path']
    assert t_inf.load_models(str(run), device='cpu', logger=None)['epoch'] == _EPOCH
    assert j_inf.load_models(str(run))['epoch'] == _EPOCH
    for name in ('model_1.pkl', 'checkpoint.pkl'):
        (run / name).write_bytes(b'')
    assert t_ckpt.resolve_checkpoint_file(str(run)) == str(run / 'checkpoint.pkl')
    assert t_ckpt.resolve_checkpoint_file(str(run), 1) == str(run / 'model_1.pkl')
    assert t_ckpt.resolve_checkpoint_file(str(run), _EPOCH) == str(run / f'model_{_EPOCH}.pth')
    (run / 'model_2.orbax').mkdir()
    with pytest.raises(NotImplementedError, match='orbax'):
        t_ckpt.resolve_checkpoint_file(str(run))
    with pytest.raises(NotImplementedError, match='orbax'):
        t_ckpt.resolve_checkpoint_file(str(run), 2)
    assert t_ckpt.resolve_checkpoint_file(str(run), 1) == str(run / 'model_1.pkl')
    # --resume takes the directory's file, or the .pth itself.
    only_pth = tmp_path / 'checkpoints' / 'v7_pth'
    only_pth.mkdir(parents=True)
    os.link(pth['path'], only_pth / 'checkpoint.pth')
    root = ['--checkpoint_root', str(tmp_path / 'checkpoints')]
    assert train_args(pth['argv'] + root + ['--resume', 'v7']).resume == \
        str(only_pth / 'checkpoint.pth')
    assert train_args(pth['argv'] + ['--resume', pth['path']]).resume == pth['path']


def test_reference_pth_warm_start_lockstep_with_jax(pth, monkeypatch):
    '''Trainer.resume of the .pth against the JAX Trainer.resume: weights
    and epoch loaded, AdamW fresh, the step count at (epoch + 1) x
    steps_per_epoch; 2 train steps in lockstep.'''
    _no_random_fps(monkeypatch)
    monkeypatch.setattr(j_train, 'LOG_EVERY', 1)
    monkeypatch.setattr(t_train, 'LOG_EVERY', 1)
    queries, targets = _supervision(2, 96, 13)
    jtr = j_train.Trainer(j_train_args(pth['argv']), 'greater',
                          logger=JStepLogger(context='jwarm'))
    jtr.resume(pth['path'], steps_per_epoch=_STEPS)
    jtr.pipeline.sampler = _JFixedSampler(queries, targets, 48)
    cfg = train_args(pth['argv'])
    cfg.device = 'cpu'
    notes = []
    logger = StepLogger(context='twarm')
    logger.info = notes.append
    tr = t_train.Trainer(cfg, 'greater', logger=logger)
    tr.resume(pth['path'], steps_per_epoch=_STEPS)
    tr.pipeline.sampler = _TFixedSampler(queries, targets, 48)
    assert any('reference .pth' in str(n) for n in notes)
    assert tr.start_epoch == jtr.start_epoch == _EPOCH + 1
    assert tr.step_count == int(jtr.state['step']) == (_EPOCH + 1) * _STEPS
    assert int(tr.optimizer.count) == 0
    assert all(float(m.abs().max()) == 0.0 for m in tr.optimizer.mu)
    init = {n: p.detach().clone() for n, p in _named(tr).items()}
    ref = t_ckpt.from_jax_params(pth['variables']['encoder'], tr.encoder)
    assert all(torch.equal(p.detach(), ref[n]) for n, p in tr.encoder.named_parameters())
    jh = jtr.run_epoch(_EPOCH + 1, 'train', iter(pth['batches']))
    th = tr.run_epoch(_EPOCH + 1, 'train', iter(pth['batches']))
    _assert_logged_close(th, jh, 'warm start')
    jparams = jax.tree_util.tree_map(np.asarray, jtr.state['params'])
    assert _rel_delta(tr, jparams, init) < 5e-4
    assert tr.step_count == int(jtr.state['step']) == (_EPOCH + 1) * _STEPS + _STEPS
    assert int(tr.optimizer.count) == _STEPS
