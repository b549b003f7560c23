'''
The eval-frame driver: a closed loop of evaluation frames through the user's
eval loop, evaluate.test_driver.run_test with --save_metrics, on a seeded
synthetic GREATER scene read by the port's test loader: each frame is
encoded, decoded over the dense grid, fetched, split and scored with the
paper's metrics (evaluate/metrics.py, its 1-NN on the host), the frame's
record kept for the scene's pickle.

Mix parameters (mixes/<name>.json):
  num_sample, point_sample_mode, implicit_batch_size, track_mode, eval_overlap
                 the evaluation's flags (config.TestConfig);
  scene          data/synthetic.py make_greater_scene's parameters (views,
                 frames, image size, objects); its seed comes from the run's;
  dataset        the TrainConfig data fields whose dataset arguments the test
                 loader takes, as a checkpoint carries them (n_data_rnd,
                 video_len, frame_skip);
  workers        the test loader's worker threads;
  in_flight      frames handed to run_test and not yet scored, at most: the
                 loop hands the next frame once the one before the last is
                 scored (two: one on the card while the post worker scores
                 the other);
  trace_frames   frames in the traced sub-window of a --trace 1 run;
  compare_frames frames the check holds against the reference, drawn from
                 the seed among the window's.

A frame is the first target frame of a test clip (time index 0): run_test
scores every frame a batch holds, so the loop hands it one-frame batches and
paces per frame. Set-up: the kernels, the weights (made from the seed, as
the scene driver's), the engine, the scene written under TMPDIR and its
loader, and one warm-up frame without metrics (the metrics compile
nothing). The window hands frames while `seconds` have not passed; scene_ms
is its wall time, from the first frame handed to run_test's return (every
frame scored, the post worker joined), over the frames completed;
peak_mem_gib the allocator's peak over the window. A --trace 1 run records
the program's spans (profiling.record_spans: the post worker's thread is
outside the profiler's) over trace_frames frames.

No cell of BENCHMARK.json runs it yet: at gv1's size a frame's host 1-NN
takes 17-24 s with the scene drawn from the seed, so scene_ms spreads by
13-19% between runs (PERF.md section 7).

The check: for the compared frames, the encoder's outputs and the squashed
grid outputs against the reference (encoder_gap, output_gap, as the scene
cells take them), and the frame's metrics against the same metrics that
reference/metrics.py computes with a plain blockwise 1-NN from the
program's own outputs and the frame's target (metrics_gap).
'''

import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from .. import compare
from .. import profile as prof
from .. import weights as W
from ..reference import metrics as ref_metrics
from ..reference import ops as ref_ops
from ..reference import scene as ref_scene
from ..reference import train as ref_train
from ..weights import stream_seed
from .scene import engine_for
from .train import release, train_config

SCENE_STREAM = 5
SAMPLE_STREAM = 6
STALL_S = 300.0      # no frame scored for this long: hand the next one anyway.


def test_config(ctx, root, **over):
    '''The TestConfig of the mix over the scene under root, back-filled from
    the configuration as evaluate's main back-fills it from a checkpoint.'''
    from occlusions4d_torch.config import TestConfig
    from occlusions4d_torch.evaluate.test_driver import backfill_from_train
    cfg, mix = ctx.config, ctx.mix
    args = TestConfig(data_path=os.path.join(root, 'data', 'test'), num_sample=mix['num_sample'],
                      point_sample_mode=mix['point_sample_mode'], save_metrics=True,
                      implicit_batch_size=mix['implicit_batch_size'],
                      track_mode=mix['track_mode'], eval_overlap=mix['eval_overlap'],
                      use_json=False, num_workers=mix['workers'], seed=ctx.seed % 2 ** 31,
                      log_path=os.path.join(root, 'logs'), test_tag=ctx.cell['config'],
                      **over)
    return backfill_from_train(args, train_config(cfg, ctx.seed, 'cpu'))


def make_loader(ctx, root, args):
    '''The synthetic scene written under root, and the port's test loader of
    it with the dataset arguments of the configuration.'''
    import dataclasses

    from occlusions4d_torch.data import create_test_loader, synthetic
    from occlusions4d_torch.data.loader import _train_dset_args
    seed = stream_seed(ctx.seed, SCENE_STREAM) % 2 ** 32
    synthetic.make_greater_scene(os.path.join(root, 'data', 'test', 'GREATER_000000'),
                                 seed=seed, **ctx.mix['scene'])
    tcfg = dataclasses.replace(train_config(ctx.config, ctx.seed, 'cpu'), **ctx.mix['dataset'])
    _, loader = create_test_loader(args, _train_dset_args(tcfg, 'greater', None),
                                   quiet_logger(None))
    return loader


def quiet_logger(log_dir):
    '''The eval loop's StepLogger, its log to stderr (standard output
    carries the result); artifacts under log_dir.'''
    import logging
    import sys

    from occlusions4d_torch.utils.logvis import StepLogger
    logger = StepLogger(log_dir=log_dir, context='test')
    for h in list(logger.logger.handlers):
        logger.logger.removeHandler(h)
    logger.logger.addHandler(logging.StreamHandler(sys.stderr))
    logger.logger.setLevel(logging.WARNING)
    return logger


def frames(loader):
    '''Endless one-frame batches: each test clip's first target frame, the
    loader's epochs in turn.'''
    for epoch in range(10 ** 9):
        n = 0
        for batch in loader.epoch(epoch):
            n += 1
            yield dict(batch, pcl_target=batch['pcl_target'][:, :1],
                       pcl_target_valid=batch['pcl_target_valid'][:, :1])
        if n == 0:
            raise ValueError('the test loader yields no clip')


class Feed:
    '''The loop's data: hands run_test frames from `source`, at most
    `in_flight` of them unscored (the eval loop's PhaseTimer counts each
    frame's metrics), while `more()` holds, or `count` of them; keeps each
    handed batch.'''

    def __init__(self, source, logger, in_flight, count=None, more=None):
        self.source, self.logger, self.in_flight = source, logger, in_flight
        self.count, self.more = count, more
        self.batches = []

    def scored(self):
        timer = getattr(self.logger, 'last_eval_timer', None)
        return 0 if timer is None else timer.counts.get('metrics', 0)

    def epoch(self, epoch):
        while self.count is None or len(self.batches) < self.count:
            last, t_last = self.scored(), time.time()
            while len(self.batches) - self.scored() >= self.in_flight:
                if self.scored() != last:
                    last, t_last = self.scored(), time.time()
                elif time.time() - t_last > STALL_S:
                    break       # run_test's next submit raises a worker's error.
                time.sleep(0.005)
            if self.more is not None and not self.more():
                return
            self.batches.append(next(self.source))
            yield self.batches[-1]


class Capture:
    '''Keeps what the engine's encode and decode_all return (the device
    tensors), a frame a call (track_mode none: one encode and one decode a
    frame), wrapping whatever the engine's attributes are now.'''

    def __init__(self, engine):
        self.engine = engine
        self.encoded, self.decoded = [], []

    def _wrap(self, attr, keep):
        fn = getattr(self.engine, attr)

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            keep.append(out)
            return out
        return call

    def __enter__(self):
        self.saved = {a: self.engine.__dict__.get(a) for a in ('encode', 'decode_all')}
        self.engine.encode = self._wrap('encode', self.encoded)
        self.engine.decode_all = self._wrap('decode_all', self.decoded)
        return self

    def __exit__(self, *exc):
        for a, fn in self.saved.items():
            if fn is None:
                delattr(self.engine, a)
            else:
                setattr(self.engine, a, fn)

    def frames(self):
        return [dict(abstract=a[0][0], fg=a[1][0], output=o)
                for a, o in zip(self.encoded, self.decoded)]


def setup(ctx):
    '''The program's side of the set-up. :return (engine, weights, args,
    source, root): the engine warmed up by one frame, the TestConfig, the
    frame source and the scratch root (the caller removes it).'''
    import dataclasses

    from occlusions4d_torch.evaluate.test_driver import run_test
    from occlusions4d_torch.ops import _build

    dev = torch.device(ctx.device)
    if dev.type == 'cuda':
        _build.build_all()
    weights = W.make_weights(ctx.config, ctx.seed, dev)
    engine = engine_for(ctx.config, ctx.mix, weights, dev)
    root = tempfile.mkdtemp(prefix='portbench_eval_')
    try:
        args = test_config(ctx, root)
        source = frames(make_loader(ctx, root, args))
        warm = quiet_logger(os.path.join(root, 'logs'))
        run_test(dataclasses.replace(args, save_metrics=False), engine, 'greater',
                 Feed(source, warm, ctx.mix['in_flight'], count=1), warm)
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    return engine, weights, args, source, root


def run_frames(ctx, engine, args, source, root, count=None, more=None):
    '''One run_test over frames from source. :return (summary, the handed
    batches, the engine's outputs a frame).'''
    from occlusions4d_torch.evaluate.test_driver import run_test
    logger = quiet_logger(os.path.join(root, 'logs'))
    feed = Feed(source, logger, ctx.mix['in_flight'], count=count, more=more)
    with Capture(engine) as cap:
        summary = run_test(args, engine, 'greater', feed, logger)
    if engine.device.type == 'cuda':
        torch.cuda.synchronize()
    return summary, feed.batches, cap.frames()


def sample(ctx, n):
    '''The window's frames that the check compares, drawn from the seed.'''
    rng = np.random.default_rng(stream_seed(ctx.seed, SAMPLE_STREAM))
    k = min(ctx.mix['compare_frames'], n)
    return sorted(int(i) for i in rng.choice(n, size=k, replace=False))


def target_frame(batch):
    '''The frame's target rows as run_test takes them: (M, E) numpy.'''
    tgt = np.asarray(batch['pcl_target'][0][0])
    return tgt[np.asarray(batch['pcl_target_valid'][0][0])]


def reference(ctx, weights, results, indices, tf32=False):
    """The reference's readings of frames `indices` of `results` (frame i:
    dict(batch, abstract, fg, output, metrics) of the program; with tf32 the
    TF32 control in the program's place, against the reference's own)."""
    cfg, mix = ctx.config, ctx.mix
    dev = torch.device(ctx.device)
    base = ref_scene.SceneReference(cfg, weights, dev)
    queries = ref_ops.grid_queries(mix['num_sample'], cfg['min_z'], cfg['cr_cube_bounds'], 0,
                                   'greater', cfg['cube_mode'])
    enc_gap = out_gap = met_gap = 0.0
    for i in indices:
        r = results[i]
        cloud = np.asarray(r['batch']['pcl_input'][0], np.float32)
        target = target_frame(r['batch'])
        abstract, fg = base.encode(cloud)
        want = base.decode(queries, abstract, fg)
        if tf32:
            with ref_train.precision(True):
                g_abs, g_fg = base.encode(cloud)
                got = dict(abstract=g_abs, fg=g_fg, output=base.decode(queries, g_abs, g_fg))
            want_m = ref_metrics.frame_metrics(want, queries, target, cfg)
            got_m = ref_metrics.frame_metrics(want, queries, target, cfg, tf32=True)
        else:
            got = r
            got_m = r['metrics']
            want_m = ref_metrics.frame_metrics(torch.as_tensor(got['output'], device=dev),
                                               queries, target, cfg)
        enc_gap = compare.worst([enc_gap, compare.scaled_gap(got['abstract'], abstract),
                                 compare.scaled_gap(got['fg'], fg)])
        out_gap = compare.worst([out_gap, compare.scaled_gap(got['output'], want)])
        met_gap = compare.worst([met_gap, ref_metrics.gap(got_m, want_m)])
        if not math.isfinite(out_gap):
            break
    return dict(encoder_gap=enc_gap, output_gap=out_gap, metrics_gap=met_gap)


def results_of(summary, batches, outputs):
    '''Frame i's dict(batch, abstract, fg, output, metrics), for the frames
    run_test scored.'''
    per_frame = (summary or {}).get('per_frame', [])
    return {i: dict(o, batch=batches[i], metrics=m)
            for i, (o, m) in enumerate(zip(outputs, per_frame))}


def run(ctx):
    engine, weights, args, source, root = setup(ctx)
    try:
        return _run(ctx, engine, weights, args, source, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(ctx, engine, weights, args, source, root):
    dev = torch.device(ctx.device)
    cuda = dev.type == 'cuda'
    cfg = ctx.config
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = dict(setup_s=t0 - ctx.t_start)
    if not ctx.trace:
        summary, batches, outputs = run_frames(
            ctx, engine, args, source, root, more=lambda: time.time() - t0 < ctx.seconds)
        t1 = time.time()
        n = len((summary or {}).get('per_frame', []))
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        out['end_to_end'] = dict(scene_ms=(t1 - t0) * 1e3 / max(n, 1),
                                 peak_mem_gib=peak / 2 ** 30)
    else:
        from occlusions4d_torch.utils import profiling
        k = ctx.mix['trace_frames']
        with prof.CudaTimer(engine, 'encode', dev) as enc_t, \
                prof.CudaTimer(engine, 'decode_all', dev) as dec_t:
            profiling.record_spans(True)
            try:
                (summary, batches, outputs), trace = prof.capture(
                    lambda: run_frames(ctx, engine, args, source, root, count=k), dev)
            finally:
                profiling.record_spans(False)
            enc_ms, dec_ms = enc_t.times(), dec_t.times()
        n = len((summary or {}).get('per_frame', []))
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        out.update(busy_s=trace['busy_s'], window_s=trace['window_s'],
                   breakdown=dict(device_ops=trace['device_ops'], idle_gaps=trace['idle_gaps']))
        queries = ctx.mix['num_sample'] if not outputs else outputs[-1]['output'].shape[0]
        out['layer'] = dict(items=n, trace=trace,
                            events_ms=dict(encode=enc_ms, decode=dec_ms),
                            flops_per_item=ctx.work.scene_flops(cfg, queries),
                            attn_fwd_per_item=ctx.work.scene_attention_forward(cfg, queries))
    out['window_wall_s'] = time.time() - t0
    results = results_of(summary, batches, outputs)
    finite = {i: bool(torch.isfinite(r['output']).all()) for i, r in results.items()}
    out.update(attempted=len(batches), failed=len(batches) - sum(finite.values()),
               memory_peak_bytes=max(setup_peak, peak) if cuda else 0)

    # The check: the program's state freed, the sampled frames against the
    # reference.
    compared = sample(ctx, len(results))
    out['compared'] = compared
    t_check = time.time()
    del engine
    release()
    if compared:
        out['readings'] = reference(ctx, weights, results, compared)
    else:
        out['readings'] = dict(encoder_gap=math.inf, output_gap=math.inf, metrics_gap=math.inf)
    out['check_s'] = time.time() - t_check
    return out
