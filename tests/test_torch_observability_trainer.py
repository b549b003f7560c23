'''
The train driver's observability held against the JAX Trainer on the CPU,
on tests/test_train.py's tiny GREATER setup (test_check_numerics_localizes_
nan's): the fixed-supervision cases are tests/test_torch_observability.py.
  (b) --check_numerics: a NaN pcl_input raises naming pcl_input, a NaN
      decoder weight raises naming decoder_output_frame0, in both packages;
      the port's clean train (with its viz export) and val_aug epochs pass,
      on the module paths with remat off, as the JAX Trainer forces them;
  (d) --profile_steps 2: the profiler's start and stop, spied on in both
      Trainers (jax.profiler.start_trace / stop_trace, the port's
      utils.profiling.start_trace / stop_trace), at steps 1 and 3 of epoch
      0, and at the raise of a loop that fails after step 1; on the CPU the
      port writes a trace file holding train_step_1 and train_step_2 and no
      other step; device_trace and annotate as the JAX package's: no trace
      when disabled or without a directory, else one file holding the
      annotated span.
'''

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from occlusions4d_tpu import train as j_train
from occlusions4d_tpu.config import TrainConfig as JTrainConfig
from occlusions4d_tpu.data import create_train_val_loaders as j_loaders
from occlusions4d_tpu.data import synthetic as j_synthetic
from occlusions4d_tpu.utils.logvis import StepLogger as JStepLogger
from occlusions4d_torch import train as t_train
from occlusions4d_torch.config import TrainConfig
from occlusions4d_torch.utils import profiling
from occlusions4d_torch.utils.logvis import StepLogger


_TINY = dict(n_points=256, n_data_rnd=512, video_len=4, frame_skip=2, past_frames=2,
             future_frames=0, pt_cube_bounds=5.0, pt_feat_dim=4, up_down_blocks=2,
             transition_factor=4, pt_num_neighbors=4, down_neighbors=4, global_size=8,
             num_cr_local_feats=4, implicit_mlp_blocks=3, cross_attn_layers=1,
             cross_attn_neighbors=4, num_cr_solid=64, air_sampling_ratio=1.5,
             color_mode='rgb_nosigmoid', color_lw=1.0, tracking_lw=1.0, num_epochs=2,
             seed=7, output_path='', batch_size=2, data_parallel=1, check_numerics=True,
             profile_steps=2)


@pytest.fixture(scope='module')
def greater(tmp_path_factory):
    '''A synthetic GREATER root, the JAX loader's first 4 train batches
    (both Trainers step on them) and a JAX Trainer under check_numerics.'''
    root = str(tmp_path_factory.mktemp('obs_greater'))
    j_synthetic.make_greater_dataset(root, num_scenes=1, num_views=2, num_frames=16,
                                     image_size=32, stages=('train', 'val'))
    cfg = JTrainConfig(data_path=root, **_TINY)
    logger = JStepLogger(log_dir=str(tmp_path_factory.mktemp('obs_jax_log')),
                         context='obs', batch_size=2)
    kind, loader, _, _ = j_loaders(cfg, logger)
    batches = []
    for b in loader.epoch(0):
        batches.append(b)
        if len(batches) == 4:
            break
    jtr = j_train.Trainer(cfg, kind, logger=logger)
    assert not jtr.pipeline.fused_decoder and jtr.check_numerics
    jtr.init_state(batches[0], steps_per_epoch=4)
    return root, batches, jtr


def _port_trainer(root, log_dir=None, **over):
    cfg = TrainConfig(data_path=root, **dict(_TINY, device='cpu', **over))
    tr = t_train.Trainer(cfg, 'greater', logger=StepLogger(
        log_dir=None if log_dir is None else str(log_dir), context='obs_t', batch_size=2))
    return tr.init_state(seed=0)


def _bad_input(batch):
    return dict(batch, pcl_input=np.full_like(batch['pcl_input'], np.nan))


def test_check_numerics_names_the_tensor_in_both_packages(greater, tmp_path):
    '''(b) The port: its module paths and probes; clean train (viz export
    at step 0) and val_aug epochs; both named raises, in the train and the
    val_aug step. JAX: the same raises from its checkified val_aug step (the
    same probed pipeline.forward as its train step's; JAX's own
    tests/test_train.py runs its train and viz steps so).'''
    root, batches, jtr = greater
    tr = _port_trainer(root, tmp_path / 'log')
    assert not tr.pipeline.fused_decoder and not tr.pipeline.remat
    assert tr.pipeline.debug_checks and tr.fused_attention == 'off'
    assert all(blk.layer2.fused == 'off' for blk in tr.encoder.blocks[::2])
    tr.run_epoch(1, 'train', iter(batches[:1]))
    tr.run_epoch(1, 'val_aug', iter(batches[1:2]))
    assert glob.glob(str(tmp_path / 'log' / '**' / '*.npy'), recursive=True)  # viz ran.
    with pytest.raises(RuntimeError, match='NaN/Inf detected in pcl_input'):
        tr.run_epoch(1, 'train', iter([_bad_input(batches[0])]))
    with pytest.raises(RuntimeError, match='NaN/Inf detected in pcl_input'):
        tr.run_epoch(1, 'val_aug', iter([_bad_input(batches[0])]))
    with pytest.raises(Exception, match='NaN/Inf detected in pcl_input'):
        jtr.run_epoch(1, 'val_aug', iter([_bad_input(batches[0])]))

    # A NaN weight of the decoder's output layer: its first frame's output.
    with torch.no_grad():
        tr.decoder.lin_out.weight[0, 0] = float('nan')
    with pytest.raises(RuntimeError, match='NaN/Inf detected in decoder_output_frame0'):
        tr.run_epoch(1, 'train', iter(batches[:1]))
    saved = jtr.state
    params = jax.tree_util.tree_map(np.array, jtr.state['params'])
    params['decoder']['params']['backbone']['lin_out']['kernel'][0, 0] = np.nan
    jtr.state = dict(jtr.state, params=params)
    try:
        with pytest.raises(Exception, match='NaN/Inf detected in decoder_output_frame0'):
            jtr.run_epoch(1, 'val_aug', iter(batches[:1]))
    finally:
        jtr.state = saved


class _Spy:
    '''Records at which step (batches consumed) the trace starts and stops.'''

    def __init__(self):
        self.events, self.consumed = [], 0

    def feed(self, batches, fail_after=None):
        for i, b in enumerate(batches):
            if fail_after is not None and i > fail_after:
                raise ValueError('loader failed')
            self.consumed = i + 1
            yield b

    def start(self, *a, **k):
        self.events.append(('start', self.consumed))

    def stop(self, *a, **k):
        self.events.append(('stop', self.consumed))


def test_profile_steps_trace_steps_one_to_three(greater, tmp_path, monkeypatch):
    '''(d) Both Trainers start the trace before step 1 (one batch consumed)
    and stop it before step 3, and at the raise of a failing loop; the port
    writes the trace on the CPU.'''
    root, batches, jtr = greater
    tr = _port_trainer(root, tmp_path / 'log', check_numerics=False)
    # JAX's loop around a stand-in step: where its trace starts and stops
    # is the loop's, whatever the step computes.
    monkeypatch.setattr(jtr, '_train_step', lambda state, batch, k, want: (state, dict(
        total_loss=np.float32(0.0), grads_finite=np.bool_(True),
        params_finite=np.bool_(True))))
    monkeypatch.setattr(jtr, '_export_intermediates', lambda *a, **k: None)
    runs = {}
    for name, trainer, module in (('jax', jtr, jax.profiler), ('torch', tr, profiling)):
        for fail in (None, 1):
            spy = _Spy()
            monkeypatch.setattr(module, 'start_trace', spy.start)
            monkeypatch.setattr(module, 'stop_trace', spy.stop)
            if fail is None:
                trainer.run_epoch(0, 'train', spy.feed(batches))
            else:
                with pytest.raises(Exception, match='loader failed'):
                    trainer.run_epoch(0, 'train', spy.feed(batches, fail_after=fail))
            runs[name, fail] = spy.events
            monkeypatch.setattr(module, 'start_trace', None)
    monkeypatch.undo()
    assert runs['jax', None] == runs['torch', None] == [('start', 1), ('stop', 3)]
    assert runs['jax', 1] == runs['torch', 1] == [('start', 1), ('stop', 2)]
    # Epoch 1 and the val stage trace nothing.
    spy = _Spy()
    monkeypatch.setattr(profiling, 'start_trace', spy.start)
    tr.run_epoch(1, 'train', spy.feed(batches[:2]))
    tr.run_epoch(0, 'val_aug', spy.feed(batches[:2]))
    assert spy.events == []
    monkeypatch.undo()

    # The real trace: a file under <log_dir>/profile with steps 1 and 2.
    tr.run_epoch(0, 'train', iter(batches))
    files = glob.glob(str(tmp_path / 'log' / 'profile' / '*.pt.trace.json'))
    assert len(files) == 1 and profiling._ACTIVE is None
    with open(files[0]) as f:
        events = json.load(f)['traceEvents']
    steps = sorted({e['name'] for e in events if e.get('name', '').startswith('train_step_')})
    assert steps == ['train_step_1', 'train_step_2']


def test_device_trace_and_annotate_as_jax(tmp_path, monkeypatch):
    from occlusions4d_tpu.utils import profiling as j_profiling
    started = []
    monkeypatch.setattr(jax.profiler, 'start_trace', lambda d: started.append(('jax', d)))
    monkeypatch.setattr(jax.profiler, 'stop_trace', lambda: None)
    monkeypatch.setattr(profiling, 'start_trace', lambda d: started.append(('torch', d)))
    for enabled, log_dir in ((False, str(tmp_path)), (True, '')):
        for module in (j_profiling, profiling):
            with module.device_trace(log_dir, enabled=enabled):
                pass
    assert started == []
    monkeypatch.undo()
    with profiling.device_trace(str(tmp_path / 'trace')):
        with profiling.annotate('o4d_span_test'):
            torch.ones(8).sum()
    files = os.listdir(tmp_path / 'trace')
    assert len(files) == 1 and files[0].endswith('.pt.trace.json')
    with open(tmp_path / 'trace' / files[0]) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert 'o4d_span_test' in names and profiling._ACTIVE is None
