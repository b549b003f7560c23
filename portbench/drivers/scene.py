'''
The scene driver: a closed loop of dense scenes through the port's
inference engine, as the evaluation runs each frame: dispatch_inference (a
fresh input cloud handed in, the grid's queries, encode, decode in chunks)
then finish_inference (the outputs fetched to the host, the density split),
without the metrics' ground-truth 1-NN.

Mix parameters (mixes/<name>.json):
  num_sample, point_sample_mode, implicit_batch_size, track_mode
                       the evaluation's flags (the reference's README.md:52);
  time_steps           scene i queries time index i mod time_steps;
  trace_scenes         scenes in the traced sub-window of a --trace 1 run;
  compare_scenes       scenes that the check holds against the reference,
  sample_pool          drawn from the seed among the run's first sample_pool
                       scenes; only their outputs (and the last scene's, which
                       stands in where a slow run finished none of them) are
                       kept, as an evaluation loop drops each frame's.

One warm-up scene (its own cloud) is set-up. scene_ms is the window's wall
time, from the first cloud handed in to the last scene's outputs on the
host, over the scenes it completed; peak_mem_gib the allocator's peak over
the window.
'''

import math
import time

import numpy as np
import torch

from .. import compare, inputs
from .. import profile as prof
from .. import weights as W
from ..reference import ops as ref_ops
from ..reference import scene as ref_scene
from ..reference import train as ref_train
from ..weights import stream_seed
from .train import release

WARMUP_INDEX = 10 ** 6     # the warm-up cloud's index, apart from the window's.
SAMPLE_STREAM = 4


def engine_for(cfg, mix, weights, dev):
    from occlusions4d_torch.evaluate.inference import InferenceEngine
    from occlusions4d_torch.models import build_models

    from .train import train_config
    tcfg = train_config(cfg, 0, dev)
    encoder, decoder, _, _ = build_models(tcfg)
    encoder.fps_random_start = False          # deterministic evaluation, as load_models.
    W.load_into(dict(encoder=encoder, decoder=decoder), weights)
    loaded = dict(encoder=encoder.to(dev).eval(), decoder=decoder.to(dev).eval(), device=dev)
    return InferenceEngine(loaded, cfg['color_mode'], cfg['segmentation_lw'] > 0.0,
                           cfg['semantic_classes'], track_mode=mix['track_mode'],
                           implicit_batch_size=mix['implicit_batch_size'],
                           precision='auto', query_parallel=1)


def setup(ctx):
    """The program's side of the set-up: kernels, weights, the engine and one
    warm-up scene. :return (engine, weights, scene): scene(i) runs the run's
    scene i and returns its outputs on the host."""
    from occlusions4d_torch.evaluate.inference import dispatch_inference, finish_inference
    from occlusions4d_torch.ops import _build

    dev = torch.device(ctx.device)
    cfg, mix = ctx.config, ctx.mix
    kind = cfg['data_kind']
    if dev.type == 'cuda':
        _build.build_all()
    weights = W.make_weights(cfg, ctx.seed, dev)
    engine = engine_for(cfg, mix, weights, dev)

    def scene(index):
        with prof.span('scene_input'):
            cloud = inputs.scene_cloud(cfg, kind, ctx.seed, index)
        with prof.span('dispatch_inference'):
            pending = dispatch_inference(
                cloud, None, engine, cfg['min_z'], cfg['cr_cube_bounds'], cfg['color_mode'],
                index % mix['time_steps'], num_sample=mix['num_sample'],
                point_sample_mode=mix['point_sample_mode'], track_mode=mix['track_mode'],
                data_kind=kind, cube_mode=cfg['cube_mode'])
        with prof.span('finish_inference'):
            res = finish_inference(pending, None, engine,
                                   predict_segmentation=cfg['segmentation_lw'] > 0.0,
                                   semantic_classes=cfg['semantic_classes'])
        return dict(output=res['implicit_output'], abstract=res['pcl_abstract'],
                    fg=res['features_global'])

    scene(WARMUP_INDEX)
    return engine, weights, scene


def sample(ctx):
    """The scenes that the check compares, drawn from the seed."""
    rng = np.random.default_rng(stream_seed(ctx.seed, SAMPLE_STREAM))
    return {int(i) for i in rng.choice(ctx.mix['sample_pool'], size=ctx.mix['compare_scenes'],
                                       replace=False)}


def reference(ctx, weights, results, indices, tf32=False):
    """The reference's readings of scenes `indices` against `results`
    (scene i's outputs, abstract cloud and global feature; the reference's
    own, with tf32 the TF32 control, when results is None)."""
    cfg, mix = ctx.config, ctx.mix
    kind = cfg['data_kind']
    dev = torch.device(ctx.device)
    base = ref_scene.SceneReference(cfg, weights, dev)
    low = ref_scene.SceneReference(cfg, weights, dev) if results is None else None
    enc_gap = out_gap = 0.0
    for i in indices:
        cloud = inputs.scene_cloud(cfg, kind, ctx.seed, i)
        queries = ref_ops.grid_queries(mix['num_sample'], cfg['min_z'], cfg['cr_cube_bounds'],
                                       i % mix['time_steps'], kind, cfg['cube_mode'])
        abstract, fg = base.encode(cloud)
        want = base.decode(queries, abstract, fg)
        if results is None:
            with ref_train.precision(tf32):
                g_abs, g_fg = low.encode(cloud)
                got = dict(abstract=g_abs, fg=g_fg, output=low.decode(queries, g_abs, g_fg))
        else:
            got = results[i]
        enc_gap = compare.worst([enc_gap, compare.scaled_gap(got['abstract'], abstract),
                                 compare.scaled_gap(got['fg'], fg)])
        out_gap = compare.worst([out_gap, compare.scaled_gap(got['output'], want)])
        if not math.isfinite(out_gap):
            break
    return dict(encoder_gap=enc_gap, output_gap=out_gap)


def run(ctx):
    dev = torch.device(ctx.device)
    cuda = dev.type == 'cuda'
    cfg, mix = ctx.config, ctx.mix
    engine, weights, scene = setup(ctx)
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    keep = sample(ctx)
    kept, times = {}, []

    def one():
        i = len(times)
        t = time.time()
        r = scene(i)
        times.append(time.time() - t)
        if i - 1 not in keep:
            kept.pop(i - 1, None)       # the scene before, unless sampled.
        kept[i] = r

    t0 = time.time()
    out = dict(setup_s=t0 - ctx.t_start)
    if not ctx.trace:
        while time.time() - t0 < ctx.seconds:
            one()
        t1 = time.time()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        out['end_to_end'] = dict(scene_ms=(t1 - t0) * 1e3 / len(times),
                                 peak_mem_gib=peak / 2 ** 30)
    else:
        n = mix['trace_scenes']
        with prof.CudaTimer(engine, 'encode', dev) as enc_t, \
                prof.CudaTimer(engine, 'decode_all', dev) as dec_t:
            def traced():
                for _ in range(n):
                    one()
            _, summary = prof.capture(traced, dev)
            enc_ms, dec_ms = enc_t.times(), dec_t.times()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        out.update(busy_s=summary['busy_s'], window_s=summary['window_s'],
                   breakdown=dict(device_ops=summary['device_ops'],
                                  idle_gaps=summary['idle_gaps']))
        queries = kept[n - 1]['output'].shape[0]
        out['layer'] = dict(items=n, trace=summary,
                            events_ms=dict(encode=enc_ms, decode=dec_ms),
                            flops_per_item=ctx.work.scene_flops(cfg, queries),
                            attn_fwd_per_item=ctx.work.scene_attention_forward(cfg, queries))
    out['window_wall_s'] = time.time() - t0
    out['item_s'] = times

    # The check: the sampled scenes that finished (else the last), against
    # the reference once the program's state is freed.
    compared = sorted(keep & set(kept)) or [len(times) - 1]
    finite = [bool(np.isfinite(kept[i]['output']).all()) for i in compared]
    out.update(attempted=len(times), failed=finite.count(False),
               memory_peak_bytes=max(setup_peak, peak) if cuda else 0, compared=compared)
    t_check = time.time()
    del engine, scene
    release()
    out['readings'] = reference(ctx, weights, kept, compared)
    out['check_s'] = time.time() - t_check
    return out
