'''
The n57344 configuration with its cell n57344.train, and the eval-frame
driver, of the port's benchmark (portbench/) on the CPU at tiny widths,
through their drivers and the port's plain versions:
  * portbench/configs/n57344.json is gv1's file with n_points 57344 and
    batch 1, the cut listed and the source named;
  * n57344.train at batch 1 with gv1's heads, the decoder on its
    shared-gather route (SHARED_GATHER_MIN_M lowered below the tiny M, as M
    2124 takes it at full size): every check within a tenth of its limit
    against the plain reference, untraced and traced;
  * the encoder's spans: encoder.extract and encoder.blocks tile each step's
    train.encoder, and encoder.fps_picks counts the pyramid's picks;
  * the eval-frame driver (portbench/drivers/eval_frame.py, the cell
    gv1.eval_frame that BENCHMARK.json leaves out) at a tiny frame: every
    check within a tenth of its limit, a metric altered where it is scored
    caught; each frame's root span scene holds finish_inference's spans,
    then scene.metrics and scene.export;
  * the metrics reference (portbench/reference/metrics.py) against the
    port's evaluate/metrics.py on one frame, a planted fault and the
    lower-precision control;
  * the new readers on hand-made data.
'''

import json
import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(4)

from occlusions4d_torch.models import fused
from occlusions4d_torch.utils import profiling
from portbench import compare, registry
from portbench.reference import metrics as ref_metrics
from portbench.run import context, layer_metrics
from portbench.work._field import pyramid

# portbench/tests/conftest.py's tiny widths; n57344 keeps its batch of 1.
TINY = dict(n_points=512, pt_feat_dim=8, up_down_blocks=2, pt_num_neighbors=8,
            down_neighbors=4, global_size=16, num_cr_local_feats=4, cross_attn_neighbors=6,
            implicit_mlp_blocks=3, num_cr_solid=96, batch_size=2, past_frames=2)
TINY_N57344 = dict(TINY, n_points=2048, batch_size=1)
TINY_FRAME = dict(num_sample=4096, implicit_batch_size=1024, workers=1,
                  scene=dict(num_views=2, num_frames=16, image_size=32, num_objects=3),
                  dataset=dict(n_data_rnd=512, video_len=4, frame_skip=2))
SEED = 2 ** 31 + 11
WIDTHS = ('up_down_blocks', 'transition_factor', 'pt_feat_dim', 'pt_num_neighbors',
          'down_neighbors', 'global_size', 'num_cr_local_feats', 'implicit_mlp_blocks',
          'cross_attn_layers', 'cross_attn_neighbors', 'abstract_levels')


# The eval-frame cell, not in BENCHMARK.json (its runs spread past half of
# scene_ms's bound on the card), run from its files.
EVAL_FRAME = dict(name='gv1.eval_frame', config='gv1', traffic='eval_frame', chips=1)


def tiny_context(cell_name, trace, seconds):
    bench = registry.benchmark()
    cell = EVAL_FRAME if cell_name == EVAL_FRAME['name'] else registry.cell(bench, cell_name)
    ctx = context(bench, cell, SEED, seconds, trace, 'cpu', time.time())
    if ctx.mix['driver'] == 'train':
        ctx.config = dict(ctx.config, **TINY_N57344)
    else:
        ctx.config = dict(ctx.config, **TINY)
        ctx.mix = dict(ctx.mix, **TINY_FRAME)
    return bench, ctx


def run_cell(cell_name, trace, seconds=0.5):
    '''One run of the cell on the CPU: (ctx, run, its per-layer metrics, the
    program's spans and counters after it).'''
    bench, ctx = tiny_context(cell_name, trace, seconds)
    profiling.record_spans(False)
    profiling.reset_spans()
    run = registry.driver(ctx.mix['driver']).run(ctx)
    layer = None
    if trace:
        layer = layer_metrics(bench, ctx, run['layer'])
        if ctx.cell is EVAL_FRAME:      # its readers, read as the cell's would be.
            data = dict(run['layer'], config=ctx.config, peaks=ctx.peaks)
            layer = {m: registry.metric_reader(m)(data) for m in (
                'idle_pct.scene', 'mfu.scene', 'encode_ms.scene', 'decode_ms.scene',
                'decode_dev_ms.scene', 'metrics_host_ms.eval_frame')}
    return ctx, run, layer, profiling.spans(), profiling.counters()


@pytest.fixture(scope='module')
def train_runs():
    '''n57344.train untraced and traced, the shared route forced and counted.'''
    calls = []
    gather_interp = fused.knn_gather_interp

    def counted(*args, **kwargs):
        calls.append(1)
        return gather_interp(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused, 'SHARED_GATHER_MIN_M', 64)
        mp.setattr(fused, 'knn_gather_interp', counted)
        runs = {trace: run_cell('n57344.train', trace) for trace in (0, 1)}
    profiling.reset_spans()
    return runs, len(calls)


@pytest.fixture(scope='module')
def frame_runs():
    runs = {trace: run_cell('gv1.eval_frame', trace, seconds=1.0) for trace in (0, 1)}
    profiling.reset_spans()
    return runs


def _children(rows, i):
    return [r for r in rows if r['parent'] == i]


def _assert_tiled(parent, kids):
    assert kids and kids[0]['device_ms'][0] == parent['device_ms'][0]
    for a, b in zip(kids, kids[1:]):
        assert a['device_ms'][1] == b['device_ms'][0], (a['name'], b['name'])
    assert kids[-1]['device_ms'][1] <= parent['device_ms'][1]


def test_n57344_config_is_gv1_at_57344_points_one_example_a_card():
    gv1, n57 = registry.config('gv1'), registry.config('n57344')
    assert n57['n_points'] == 57344 and n57['batch_size'] == 1
    assert n57['reduced'] == ['batch_size'] and 'n_points' in n57['changed']
    assert 'README.md:36' in n57['source'] and 'BASELINE.json configs[4]' in n57['source']
    assert 'deployment' in n57 and n57['assumed'] == gv1['assumed']
    skip = {'source', 'reduced', 'changed', 'deployment', 'n_points', 'batch_size'}
    assert {k: v for k, v in n57.items() if k not in skip} == {
        k: v for k, v in gv1.items() if k not in skip}
    assert all(n57[k] == gv1[k] for k in WIDTHS)
    assert pyramid(n57) == [57344, 19115, 6372, 2124]
    entry = next(c for c in registry.benchmark()['configs'] if c['name'] == 'n57344')
    assert entry['reduced'] == n57['reduced'] and entry['source'] == n57['source']


@pytest.mark.parametrize('trace', [0, 1])
def test_n57344_train_runs_the_shared_route_and_agrees(train_runs, trace):
    runs, shared_calls = train_runs
    ctx, run, got, _, _ = runs[trace]
    assert shared_calls > 0
    rows, ok = compare.checks(run['readings'], ctx.limits)
    assert ok, rows
    for r in rows:            # the plain versions on both sides: far inside.
        assert r['value'] <= r['limit'] / 10, r
    assert run['attempted'] >= 1 and run['failed'] == 0
    if trace:
        assert got['encoder_extract_dev_ms.train']['value'] > 0
        assert 'fps_us_per_pick.train' not in got      # the CPU launches no o4d_fps.
    else:
        assert set(run['end_to_end']) == {'step_ms', 'peak_mem_gib'}


def test_encoder_spans_tile_train_encoder_and_count_picks(train_runs):
    runs, _ = train_runs
    ctx, run, _, rows, counters = runs[1]
    cfg = ctx.config
    steps = {r['item'] for r in rows if r['name'].startswith('train_step_')}
    encoders = [i for i, r in enumerate(rows)
                if r['name'] == 'train.encoder' and r['item'] in steps]
    assert len(encoders) == ctx.mix['trace_steps']
    levels = cfg['up_down_blocks']
    want = (['encoder.blocks'] + ['encoder.extract', 'encoder.blocks', 'encoder.extract'] * levels
            + ['encoder.extract', 'encoder.blocks'])
    for i in encoders:
        kids = _children(rows, i)
        assert [k['name'] for k in kids] == want
        assert {k['item'] for k in kids} == {rows[i]['item']}
        _assert_tiled(rows[i], kids)
        whole = rows[i]['device_ms'][1] - rows[i]['device_ms'][0]
        covered = sum(k['device_ms'][1] - k['device_ms'][0] for k in kids)
        assert 0.9 * whole <= covered <= whole
    picks = cfg['batch_size'] * sum(pyramid(cfg)[1:])
    reader = registry.metric_reader('fps_us_per_pick.train')
    assert reader.__globals__['picks_per_step'](cfg) == picks
    n = ctx.mix['trace_steps']
    assert counters['encoder.fps_picks'] == n * picks
    assert counters['encoder.points'] == n * cfg['batch_size'] * cfg['n_points']


@pytest.mark.parametrize('trace', [0, 1])
def test_gv1_eval_frame_runs_and_agrees(frame_runs, trace):
    ctx, run, got, _, _ = frame_runs[trace]
    rows, ok = compare.checks(run['readings'], ctx.limits)
    assert ok, rows
    assert [r['name'] for r in rows] == ['encoder_gap', 'output_gap', 'metrics_gap']
    for r in rows:
        assert r['value'] <= r['limit'] / 10, r
    assert run['attempted'] >= 1 and run['failed'] == 0 and run['compared']
    if trace:
        assert run['attempted'] == ctx.mix['trace_frames']
        assert all(v is not None for v in got.values()), got
        assert got['metrics_host_ms.eval_frame'] > 0
    else:
        assert set(run['end_to_end']) == {'scene_ms', 'peak_mem_gib'}


def test_eval_frame_root_holds_metrics_and_export(frame_runs):
    ctx, run, _, rows, _ = frame_runs[1]
    roots = [i for i, r in enumerate(rows) if r['name'] == 'scene']
    assert len(roots) == ctx.mix['trace_frames']
    for i in roots:
        kids = _children(rows, i)
        assert [k['name'] for k in kids] == [
            'scene.grid', 'scene.encode', 'scene.decode', 'scene.fetch', 'scene.post',
            'scene.post', 'scene.metrics', 'scene.export']
        _assert_tiled(rows[i], kids)
        assert {k['item'] for k in kids} == {rows[i]['item']}
        # The root closes after its last tile, on the post worker's thread.
        assert rows[i]['host_ms'][1] >= kids[-1]['host_ms'][1]
        assert kids[-1]['tid'] != kids[0]['tid']
    assert not [r for r in rows if r['name'].startswith('scene.') and r['item'] is None]


def _frame(seed=5, n_query=3000, n_target=700):
    rng = np.random.default_rng(seed)
    queries = np.concatenate([rng.random((n_query, 3), np.float32) * 4 - 2,
                              np.zeros((n_query, 1), np.float32)], -1)
    output = rng.random((n_query, 5), np.float32)
    target = rng.random((n_target, 9), np.float32) * 4 - 2
    target[:, 5:8] = rng.random((n_target, 3), np.float32)
    target[:, 8] = rng.random(n_target) > 0.7
    return queries, output, target


def _port_metrics(queries, output, target, cfg):
    from occlusions4d_torch.evaluate.metrics import frame_metrics
    io = np.concatenate([queries, output], -1)
    sel = io[:, 4] >= 0.5
    air = io[~sel]
    air = np.concatenate([air[:, :3], air[:, 4:5], -np.ones((air.shape[0], 1))], -1)
    return frame_metrics(io[sel], air, target, 'greater', cfg['point_occupancy_radius'],
                         cfg['color_mode'], False, cfg['semantic_classes'])


def test_metrics_reference_matches_the_port_and_fails_a_fault():
    cfg = registry.config('gv1')
    limit = registry.limits('gv1.eval_frame')['metrics_gap']
    queries, output, target = _frame()
    port = _port_metrics(queries, output, target, cfg)
    ref = ref_metrics.frame_metrics(torch.as_tensor(output), queries, target, cfg)
    assert set(port) == set(ref) >= {'occupancy_f1', 'chamfer', 'color_mae',
                                     'tracking_precision'}
    assert ref_metrics.gap(dict(port, step=0, time_idx=0), ref) <= limit / 10
    # A metric the program got wrong, or left out, fails.
    assert ref_metrics.gap(dict(port, chamfer=port['chamfer'] * 1.01), ref) > limit
    assert ref_metrics.gap({k: v for k, v in port.items() if k != 'color_mae'}, ref) > limit
    # The control: the 1-NN's points rounded to TF32 move the metrics past
    # the limit.
    low = ref_metrics.frame_metrics(torch.as_tensor(output), queries, target, cfg, tf32=True)
    assert ref_metrics.gap(low, ref) > limit
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0 - 2.0 ** -20])
    assert ref_metrics.round_tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0]


def test_new_readers_on_hand_made_data(monkeypatch):
    cfg = registry.config('n57344')
    read = registry.metric_reader('fps_us_per_pick.train')
    span_s = {'o4d_fps_cluster': 0.0341 * 2, 'o4d_knn_pruned': 1.0}
    got = read(dict(items=2, trace=dict(span_s=span_s), config=cfg))
    assert got == pytest.approx(1e6 * 0.0341 / 27611)
    assert read(dict(items=2, trace=dict(span_s={}), config=cfg)) is None

    rows = [dict(name='scene', parent=None, item=i, tid=0, host_ms=(0.0, 9.0),
                 device_ms=(0.0, 9.0), clock='host') for i in range(3)]
    rows += [dict(name='scene.metrics', parent=i, item=i, tid=1, host_ms=(1.0, 1.0 + ms),
                  device_ms=(1.0, 1.5), clock='cuda:0') for i, ms in enumerate((50.0, 7.0, 9.0))]
    monkeypatch.setattr(profiling, 'spans', lambda: rows)
    host = registry.metric_reader('metrics_host_ms.eval_frame')
    assert host(dict(items=2)) == pytest.approx(8.0)
    extract = registry.metric_reader('encoder_extract_dev_ms.train')
    assert extract(dict(items=2)) is None
    # encoder.extract under a step's train.encoder counts, under a scene's
    # scene.encode not.
    rows += [dict(name=name, parent=parent, item=item, tid=0, host_ms=(0.0, 1.0),
                  device_ms=(0.0, ms), clock='cuda:0')
             for name, parent, item, ms in (('train.encoder', None, 1, 30.0),
                                             ('encoder.extract', 6, 1, 4.0),
                                             ('encoder.extract', 6, 1, 2.0),
                                             ('scene.encode', 2, 2, 9.0),
                                             ('encoder.extract', 9, 2, 5.0))]
    assert extract(dict(items=2)) == pytest.approx(3.0)
    monkeypatch.delattr(profiling, 'spans')    # a program without spans.
    assert host(dict(items=2)) is None


def test_benchmark_entries_of_the_new_cell():
    bench = registry.benchmark()
    cells = {w['name']: w for w in bench['workloads']}
    assert cells['n57344.train']['config'] == 'n57344' and cells['n57344.train']['chips'] == 1
    assert 'gv1.eval_frame' not in cells
    e2e = {m['name'] for m in registry.end_to_end_for(bench, 'n57344.train')}
    assert e2e == {'step_ms', 'peak_mem_gib', 'setup_s'}
    train = {m['name'] for m in registry.per_layer_for(bench, 'gv1.train')}
    assert train == {m['name'] for m in registry.per_layer_for(bench, 'n57344.train')}
    assert {'encoder_extract_dev_ms.train', 'fps_us_per_pick.train'} <= train
    with open(os.path.join(registry.HERE, 'mixes', 'eval_frame.json')) as f:
        assert json.load(f)['driver'] == 'eval_frame'


def test_feed_hands_a_frame_once_the_one_before_the_last_is_scored():
    import threading
    import types

    from occlusions4d_torch.utils.profiling import PhaseTimer
    from portbench.drivers.eval_frame import Feed
    logger = types.SimpleNamespace(last_eval_timer=PhaseTimer())
    feed = Feed(iter(range(10)), logger, in_flight=2, count=3)
    it = feed.epoch(0)
    assert [next(it), next(it)] == [0, 1]
    scored_at = []

    def score():
        time.sleep(0.2)
        scored_at.append(time.time())
        logger.last_eval_timer.counts['metrics'] += 1

    threading.Thread(target=score).start()
    assert next(it) == 2 and time.time() >= scored_at[0]
    assert list(it) == [] and feed.batches == [0, 1, 2]


def test_calibrate_eval_frame_reads_the_program_and_the_control():
    from portbench import calibrate_eval_frame
    _, ctx = tiny_context('gv1.eval_frame', 0, 0.0)
    res = calibrate_eval_frame.readings(ctx, program=True, control=True)
    assert len(res['metrics']) == ctx.mix['compare_frames']
    for kind in ('program', 'control'):
        assert set(res[kind]) == set(ctx.limits)
    rows, ok = compare.checks(res['program'], ctx.limits)
    assert ok and all(r['value'] <= r['limit'] / 10 for r in rows), rows


def test_eval_frame_check_fails_a_metric_altered_where_it_is_scored(monkeypatch):
    from occlusions4d_torch.evaluate import metrics
    score = metrics.frame_metrics

    def altered(*args, **kwargs):
        m = score(*args, **kwargs)
        m['occupancy_f1'] += 1e-3
        return m

    monkeypatch.setattr(metrics, 'frame_metrics', altered)
    _, ctx = tiny_context('gv1.eval_frame', 0, 0.5)
    run = registry.driver('eval_frame').run(ctx)
    rows, ok = compare.checks(run['readings'], ctx.limits)
    assert not ok
    got = {r['name']: r['value'] for r in rows}
    assert got['metrics_gap'] >= 9e-4 and got['output_gap'] <= ctx.limits['output_gap']


def test_n57344_check_fails_a_step_that_leaves_the_state_unchanged(monkeypatch):
    from occlusions4d_torch import train
    monkeypatch.setattr(train.AdamW, 'update', lambda self, grads, norm, apply: None)
    monkeypatch.setattr(fused, 'SHARED_GATHER_MIN_M', 64)
    _, ctx = tiny_context('n57344.train', 0, 0.2)
    run = registry.driver('train').run(ctx)
    rows, ok = compare.checks(run['readings'], ctx.limits)
    assert not ok
    assert {r['name']: r['value'] for r in rows}['change_gap'] == pytest.approx(1.0)
