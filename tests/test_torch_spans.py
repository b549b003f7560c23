'''
The port's spans and counters (occlusions4d_torch/utils/profiling.py) at
the layer boundaries of the train step and the dense scene, on the CPU
(where a span's device interval is its host interval):
  * off (the default), span() is the shared null context, begin() None,
    count() nothing, and a Trainer.step registers no gradient hook;
  * under profiling.device_trace, two run_epoch steps on a synthetic
    GREATER tree: each step's root span train_step_<i> is tiled, in order,
    by train.h2d, train.encoder, train.sampler, train.decoder_fwd,
    train.decoder_bwd, train.encoder_bwd and train.optimizer; the counters
    read the steps and the queries their shapes hold; the written trace
    holds the spans as user_annotation events, none of them named o4d_;
  * a dispatch_inference + finish_inference on the committed GREATER
    anchor: the scene's root span tiled by scene.grid, scene.encode,
    scene.decode (ceil(P / chunk) scene.decode_chunk in it), scene.fetch,
    scene.post (the merge), scene.gt_nn1 and scene.post (the split); the
    counters read P queries and the chunks;
  * --profile_steps writes spans.json beside the trace, of the traced steps
    alone, and leaves an outer recording's spans in the store;
  * the store is emptied when recording starts from off, and keeps the last
    MAX_SPANS spans;
  * self time, and the store under many threads.
'''

import glob
import json
import math
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from occlusions4d_torch import train as t_train
from occlusions4d_torch.config import TrainConfig
from occlusions4d_torch.data import synthetic
from occlusions4d_torch.data.loader import create_train_val_loaders
from occlusions4d_torch.utils import profiling
from occlusions4d_torch.utils.logvis import StepLogger

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TINY = dict(n_points=256, n_data_rnd=512, video_len=4, frame_skip=2, past_frames=2,
             future_frames=0, pt_cube_bounds=5.0, pt_feat_dim=4, up_down_blocks=2,
             transition_factor=4, pt_num_neighbors=4, down_neighbors=4, global_size=8,
             num_cr_local_feats=4, implicit_mlp_blocks=3, cross_attn_layers=1,
             cross_attn_neighbors=4, num_cr_solid=64, air_sampling_ratio=1.5,
             color_mode='rgb_nosigmoid', color_lw=1.0, tracking_lw=1.0, num_epochs=2,
             seed=7, output_path='', batch_size=2, data_parallel=1, device='cpu',
             viz_interval=10 ** 6)
_STEP_SPANS = ['train.h2d', 'train.encoder', 'train.sampler', 'train.decoder_fwd',
               'train.decoder_bwd', 'train.encoder_bwd', 'train.optimizer']
_SCENE_SPANS = ['scene.grid', 'scene.encode', 'scene.decode', 'scene.fetch', 'scene.post',
                'scene.gt_nn1', 'scene.post']


@pytest.fixture(autouse=True)
def clean_store():
    profiling.record_spans(False)
    profiling.reset_spans()
    yield
    profiling.record_spans(False)
    profiling.reset_spans()


@pytest.fixture(scope='module')
def greater(tmp_path_factory):
    '''A synthetic GREATER root and its loader's first 3 train batches.'''
    root = str(tmp_path_factory.mktemp('spans_greater'))
    synthetic.make_greater_dataset(root, num_scenes=1, num_views=2, num_frames=16,
                                   image_size=32, stages=('train', 'val'))
    cfg = TrainConfig(data_path=root, **_TINY)
    _, loader, _, _ = create_train_val_loaders(cfg, StepLogger(context='spans', batch_size=2))
    batches = []
    for b in loader.epoch(0):
        batches.append(b)
        if len(batches) == 3:
            break
    return root, batches


def _trainer(root, log_dir=None, **over):
    cfg = TrainConfig(data_path=root, **dict(_TINY, **over))
    tr = t_train.Trainer(cfg, 'greater', logger=StepLogger(
        log_dir=None if log_dir is None else str(log_dir), context='spans_t', batch_size=2))
    return tr.init_state(seed=0)


def _children(rows, i):
    return [r for r in rows if r['parent'] == i]


def _assert_tiled(parent, kids, names):
    '''kids are named `names` in order and tile parent from its start.'''
    assert [k['name'] for k in kids] == names
    assert kids[0]['device_ms'][0] == parent['device_ms'][0]
    for a, b in zip(kids, kids[1:]):
        assert a['device_ms'][1] == b['device_ms'][0], (a['name'], b['name'])
        assert a['host_ms'][1] == b['host_ms'][0]
    assert kids[-1]['device_ms'][1] <= parent['device_ms'][1]


def test_spans_off_record_nothing_and_register_no_hook(greater, monkeypatch):
    root, batches = greater
    assert profiling.span('a') is profiling.span('b', tile=True, root=True)
    assert profiling.begin('c') is None and profiling.within(None) is profiling.span('d')
    profiling.count('e', 3)
    tr = _trainer(root)
    hooks = []
    register = torch.Tensor.register_hook

    def spy(self, fn):
        hooks.append(fn)
        return register(self, fn)

    monkeypatch.setattr(torch.Tensor, 'register_hook', spy)
    tr.step(batches[0])
    assert hooks == []
    assert profiling.spans() == [] and profiling.counters() == {}
    # Recording, the same step registers the decoder's backward hook.
    profiling.record_spans(True)
    tr.step(batches[1])
    assert len(hooks) == 1
    names = [r['name'] for r in profiling.spans()]
    assert names == _STEP_SPANS


def test_run_epoch_spans_tile_each_step(greater, tmp_path):
    root, batches = greater
    tr = _trainer(root)
    with profiling.device_trace(str(tmp_path / 'trace')):
        hist = tr.run_epoch(0, 'train', iter(batches[:2]))
    assert len(hist) == 1
    rows = profiling.spans()
    steps = [i for i, r in enumerate(rows) if r['name'].startswith('train_step_')]
    assert [rows[i]['name'] for i in steps] == ['train_step_0', 'train_step_1']
    epoch = [i for i, r in enumerate(rows) if r['name'] == 'train.epoch']
    assert len(epoch) == 1 and rows[epoch[0]]['parent'] is None
    assert [r['name'] for r in _children(rows, epoch[0])] == [
        'train.data', 'train_step_0', 'train.log_sync', 'train.data', 'train_step_1',
        'train.guard', 'train.data', 'train.guard']
    _assert_tiled(rows[epoch[0]], _children(rows, epoch[0]),
                  [r['name'] for r in _children(rows, epoch[0])])
    items = set()
    for i in steps:
        kids = _children(rows, i)
        _assert_tiled(rows[i], kids, _STEP_SPANS)
        assert {k['item'] for k in kids} == {rows[i]['item']}
        items.add(rows[i]['item'])
        # The seven spans cover the step but for what follows the optimizer.
        covered = kids[-1]['device_ms'][1] - kids[0]['device_ms'][0]
        whole = rows[i]['device_ms'][1] - rows[i]['device_ms'][0]
        assert 0.5 * whole < covered <= whole
    assert len(items) == 2 and None not in items
    # Two steps of batch x frames x (the sampler's solid + air queries).
    per_frame = tr.pipeline.sampler.cfg.num_solid + tr.pipeline.sampler.cfg.num_air
    queries = 2 * tr.cfg.batch_size * tr.pipeline.cfg.num_frames * per_frame
    assert profiling.counters() == {'train.steps': 2, 'train.queries_sampled': queries}
    totals = profiling.span_totals()
    assert totals['train_step_0']['calls'] == 1 and totals['train.h2d']['calls'] == 2
    assert all(t['self_ms'] <= t['device_ms'] + 1e-9 for t in totals.values())

    files = glob.glob(str(tmp_path / 'trace' / '*.pt.trace.json'))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)['traceEvents']
    annotated = {e['name'] for e in events if e.get('cat') == 'user_annotation'}
    assert set(_STEP_SPANS[:4] + ['train.optimizer', 'train.epoch', 'train.data',
                                  'train_step_0', 'train_step_1']) <= annotated
    # Only the kernels' spans are named o4d_ (trace.py gives a kernel's
    # time to its o4d_ span); the CPU launches none.
    assert not [n for n in annotated | set(totals) if n.startswith('o4d_')]


def _engine():
    from occlusions4d_torch.evaluate import inference as inf
    loaded = inf.load_models(os.path.join(_ROOT, 'tests/assets/anchor/checkpoint.pkl'),
                             device='cpu')
    cfg = loaded['train_config']
    engine = inf.InferenceEngine(loaded, cfg.color_mode, cfg.segmentation_lw > 0,
                                 cfg.semantic_classes, implicit_batch_size=1024)
    return inf, engine, cfg, loaded['data_kind']


def test_scene_spans_tile_each_scene():
    inf, engine, cfg, kind = _engine()
    rng = np.random.RandomState(3)
    pcl = rng.rand(256, 8).astype(np.float32) * 2 - 1
    pcl[:, 2] = rng.rand(256).astype(np.float32) * 2 - 0.4
    pcl[:, -1] = 0.0
    target = rng.rand(400, 11).astype(np.float32) * 2 - 1
    profiling.record_spans(True)
    results = []
    for time_idx in (0, 1):
        pending = inf.dispatch_inference(
            pcl, None, engine, cfg.min_z, cfg.cr_cube_bounds, cfg.color_mode, time_idx,
            num_sample=3000, point_sample_mode='grid', data_kind=kind,
            cube_mode=cfg.cube_mode)
        results.append(inf.finish_inference(pending, target, engine))
    rows = profiling.spans()
    scenes = [i for i, r in enumerate(rows) if r['name'] == 'scene']
    assert len(scenes) == 2
    n_queries = 0
    for i, res in zip(scenes, results):
        p = res['points_query'].shape[0]
        n_queries += p
        kids = _children(rows, i)
        _assert_tiled(rows[i], kids, _SCENE_SPANS)
        assert {k['item'] for k in kids} == {rows[i]['item']} and rows[i]['item'] is not None
        decode = rows.index(kids[2])
        chunks = _children(rows, decode)
        _assert_tiled(rows[decode], chunks, ['scene.decode_chunk'] * math.ceil(p / 1024))
        assert sorted(res['phase_s']) == ['d2h_fetch', 'device_infer', 'gt_nn1',
                                          'host_post', 'track_merge', 'track_reruns']
    assert profiling.counters() == {
        'scene.track_reruns': 2, 'scene.queries_decoded': n_queries,
        'scene.decode_chunks': sum(math.ceil(r['points_query'].shape[0] / 1024)
                                   for r in results)}
    assert rows[scenes[0]]['item'] != rows[scenes[1]]['item']


def test_profile_steps_write_spans_json(greater, tmp_path):
    root, batches = greater
    tr = _trainer(root, log_dir=tmp_path / 'log', profile_steps=1)
    tr.run_epoch(0, 'train', iter(batches))
    prof = tmp_path / 'log' / 'profile'
    assert len(glob.glob(str(prof / '*.pt.trace.json'))) == 1
    with open(prof / 'spans.json') as f:
        out = json.load(f)
    assert out['counters']['train.steps'] == 1
    assert out['spans']['train_step_1']['calls'] == 1 and 'train_step_0' not in out['spans']
    assert set(_STEP_SPANS) <= set(out['spans'])
    assert set(out['spans']['train.sampler']) == {'calls', 'host_ms', 'device_ms', 'self_ms'}
    assert profiling.begin('after the trace') is None


def test_profile_steps_keep_an_outer_recording(greater, tmp_path):
    '''Under record_spans(True) (as chip_smoke.py's epoch_spans records a
    whole epoch) the trace of --profile_steps empties nothing: the store
    keeps every step, spans.json the traced step alone.'''
    root, batches = greater
    tr = _trainer(root, log_dir=tmp_path / 'log', profile_steps=1)
    profiling.record_spans(True)
    tr.run_epoch(0, 'train', iter(batches))
    profiling.record_spans(False)
    totals = profiling.span_totals()
    assert [n for n in sorted(totals) if n.startswith('train_step_')] == [
        'train_step_0', 'train_step_1', 'train_step_2']
    assert profiling.counters()['train.steps'] == 3 and totals['train.data']['calls'] == 4
    with open(tmp_path / 'log' / 'profile' / 'spans.json') as f:
        out = json.load(f)
    assert out['counters']['train.steps'] == 1
    assert [n for n in out['spans'] if n.startswith('train_step_')] == ['train_step_1']


def test_store_empties_when_recording_starts_and_is_bounded(tmp_path):
    profiling.record_spans(True)
    with profiling.span('old'):
        profiling.count('old')
    profiling.record_spans(True)            # on already: nothing emptied.
    with profiling.device_trace(str(tmp_path / 'trace')):
        with profiling.span('traced'):
            pass
    assert [r['name'] for r in profiling.spans()] == ['old', 'traced']
    profiling.record_spans(False)
    with profiling.device_trace(str(tmp_path / 'trace2')):   # starts from off.
        m = profiling.mark()
        with profiling.span('fresh'):
            profiling.count('fresh', 2)
    assert [r['name'] for r in profiling.spans()] == ['fresh']
    assert profiling.counters() == {'fresh': 2} == profiling.counters(since=m)
    profiling.record_spans(True)            # from off: emptied.
    assert profiling.spans() == [] and profiling.counters() == {}
    m = profiling.mark()
    for i in range(profiling.MAX_SPANS + 5):
        with profiling.span(f's{i % 7}'):
            pass
    profiling.record_spans(False)
    rows = profiling.spans()
    assert len(rows) == profiling.MAX_SPANS
    assert rows[-1]['name'] == f's{(profiling.MAX_SPANS + 4) % 7}'
    assert sum(t['calls'] for t in profiling.span_totals(since=m).values()) == \
        profiling.MAX_SPANS


def test_self_time_is_less_children():
    profiling.record_spans(True)
    with profiling.span('outer'):
        with profiling.span('outer.a', tile=True):
            time.sleep(0.01)
        with profiling.span('outer.b', tile=True):
            time.sleep(0.01)
        time.sleep(0.02)
    t = profiling.span_totals()
    kids = t['outer.a']['device_ms'] + t['outer.b']['device_ms']
    assert t['outer']['self_ms'] == pytest.approx(t['outer']['device_ms'] - kids, abs=1e-6)
    assert t['outer']['self_ms'] >= 19.0 and t['outer.a']['self_ms'] >= 9.0
    assert 'outer' in profiling.spans_table(t, {})


def test_store_under_many_threads():
    '''More threads than cores, each its own stack of spans and counting into
    the shared store; no update is lost.'''
    profiling.record_spans(True)
    n_threads, n = min(4 * (os.cpu_count() or 2), 64), 200   # under MAX_SPANS.
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with profiling.span('t.outer', root=True):
                    with profiling.span('t.inner', tile=True):
                        profiling.count('t.count')
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert profiling.counters() == {'t.count': n_threads * n}
    rows = profiling.spans()
    assert len(rows) == 2 * n_threads * n
    for r in rows:
        if r['name'] == 't.inner':
            parent = rows[r['parent']]
            assert parent['name'] == 't.outer' and parent['tid'] == r['tid']
            assert parent['item'] == r['item']
