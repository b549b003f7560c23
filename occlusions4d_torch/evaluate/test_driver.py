'''
Test / evaluation driver (port of occlusions4d_tpu/evaluate/test_driver.py):
load a checkpoint, back-fill test args from its train config, loop over the
test set, run dense per-frame inference, score the frames (--save_metrics ->
metrics.json) and export the pcl_io_s{step}.p / metadata_s{step}.p artifacts
(and activations_s{step}.p, the decoder's penultimate activations of each
frame's predicted-solid queries, with --store_activations).

Run on the card:   python -m occlusions4d_torch.evaluate --resume <ckpt dir>
                       --data_path <dataset> [flags of config.TestConfig]
Run on the CPU:    test_driver.main(config.test_args(argv), device='cpu')
                   (the kernels' plain versions; what the tests do).

The post worker (--eval_overlap, the default) is a second thread that fetches
the frame's outputs from the card, merges, labels (nn1_direct on the card with
--save_gt), scores and exports while the main thread dispatches the next
frame. It runs on the main thread's device and on a CUDA stream of its own
that waits, frame by frame, for the kernels that produced the frame's tensors
(and for no later frame's); frames reach it in loop order, so metrics.json and
the artifacts are bit-identical to the serial loop's.
'''

import os
import time

import numpy as np
import torch

from .. import native, resolve_device
from ..config import TestConfig, test_args
from ..data import create_test_loader
from ..utils import profiling
from ..utils.logvis import StepLogger
from .inference import InferenceEngine, load_models

__all__ = ['run_test', 'main']


def backfill_from_train(args: TestConfig, train_cfg):
    '''Checkpoint train args override test args.'''
    args.min_z = train_cfg.min_z
    args.pt_cube_bounds = getattr(train_cfg, 'pt_cube_bounds', 5.0)
    args.cr_cube_bounds = getattr(train_cfg, 'cr_cube_bounds', 5.0)
    args.cube_mode = getattr(train_cfg, 'cube_mode', 4)
    args.color_mode = getattr(train_cfg, 'color_mode', 'rgb')
    args.segmentation_lw = train_cfg.segmentation_lw
    args.tracking_lw = getattr(train_cfg, 'tracking_lw', 0.0)
    args.point_occupancy_radius = train_cfg.point_occupancy_radius
    args.semantic_classes = getattr(train_cfg, 'semantic_classes', 13)
    return args


class _FramePost:
    '''Host post-processing of eval frames: fetch+merge the pending inference,
    score metrics, report histograms, accumulate the scene's pcl_io records,
    and export per-scene pickles. One instance per run_test call; driven either
    inline (serial eval) or from the single post worker thread (pipelined
    eval). All mutable state lives here, touched by exactly one thread at a
    time in both modes, and frames arrive in loop order either way — so
    metrics.json, artifacts, and scalars are bit-identical across modes.'''

    def __init__(self, args, engine, data_kind, logger, timer):
        self.args = args
        self.engine = engine
        self.data_kind = data_kind
        self.logger = logger
        self.timer = timer
        self.log_folder = 'test_' + args.test_tag
        self.all_metrics = []
        self.n_reruns = []
        self.pcl_all = []
        self.activations = []
        self.last_inf = None
        # Per-scene-step wall clock (completion-to-completion, measured where
        # the artifacts land — the post worker in pipelined mode): step 0
        # carries the compile/warmup cost, steps >= 1 are steady state.
        self.scene_walls = []
        self.scene_t_last = time.time()

    def frame(self, cur_step, time_idx, pending, tgt_frame, pcl_input,
              pcl_input_sem):
        '''The frame's host stage. Its root span (dispatch_inference's) stays
        open through finish_inference and is tiled on by scene.metrics
        (frame_metrics with its host 1-NN) and scene.export (the histograms
        and the record for the scene's pickle), then ended here.'''
        root = pending.get('span')
        try:
            with profiling.within(root):
                self._frame(cur_step, time_idx, pending, tgt_frame, pcl_input,
                            pcl_input_sem)
        finally:
            profiling.end(root)

    def _frame(self, cur_step, time_idx, pending, tgt_frame, pcl_input,
               pcl_input_sem):
        from .inference import finish_inference
        args = self.args
        with self.timer.phase('finish_wall'):
            inf = finish_inference(
                pending, tgt_frame if args.save_gt else None, self.engine,
                predict_segmentation=args.segmentation_lw > 0.0,
                point_occupancy_radius=args.point_occupancy_radius,
                semantic_classes=args.semantic_classes,
                density_threshold=args.density_threshold,
                compress_air=True, store_activations=args.store_activations,
                end_root=False)
        for name in ('device_infer', 'd2h_fetch', 'track_merge', 'gt_nn1',
                     'host_post'):
            self.timer.totals[name] += inf['phase_s'][name]
            self.timer.counts[name] += 1
        self.n_reruns.append(inf['phase_s']['track_reruns'])

        if args.save_metrics:
            from .metrics import frame_metrics
            with self.timer.phase('metrics'), profiling.span('scene.metrics', tile=True):
                m = frame_metrics(
                    inf['output_solid'], inf['output_air'], tgt_frame,
                    self.data_kind, args.point_occupancy_radius,
                    args.color_mode, args.segmentation_lw > 0.0,
                    args.semantic_classes,
                    mark_is_instance_id=inf['mark_is_instance_id'],
                    # Reuse the gt path's full-query 1-NN (bit-identical,
                    # saves three dense nn1 passes; absent when save_gt off).
                    nn_solid=inf.get('nn_solid'),
                    nn_air_d=inf.get('nn_air_d'))
            m.update(step=cur_step, time_idx=time_idx)
            self.all_metrics.append(m)
        with profiling.span('scene.export', tile=True):
            self._export(cur_step, time_idx, inf, tgt_frame, pcl_input, pcl_input_sem)
        self.last_inf = inf

    def _export(self, cur_step, time_idx, inf, tgt_frame, pcl_input, pcl_input_sem):
        args = self.args
        if args.store_activations and 'penult_solid' in inf:
            self.activations.append(inf['penult_solid'])

        if cur_step % 4 == 0:
          with self.timer.phase('histograms'):
            self.logger.report_implicit_histograms(
                'test', inf['implicit_output'], args.color_mode, time_idx,
                args.segmentation_lw > 0.0, args.semantic_classes,
                args.tracking_lw > 0.0, cur_step)
            # Solid/air per-channel split (the eval air rows are compressed
            # to (x, y, z, density, segm)).
            self.logger.report_pcl_air_histograms(
                'test', inf['output_solid'], inf['output_air'],
                args.color_mode, time_idx, args.segmentation_lw > 0.0,
                args.semantic_classes, args.tracking_lw > 0.0, True, cur_step)

        record = (np.asarray(pcl_input), inf['pcl_abstract'],
                  inf['output_solid'], tgt_frame, inf['output_air'])
        if args.save_gt:
            record = record + (np.asarray(pcl_input_sem), inf['points_query'])
        self.pcl_all.append(record)

    def scene_end(self, cur_step, meta, cam_RT, cam_K, pcl_input):
        args, logger, inf = self.args, self.logger, self.last_inf
        with self.timer.phase('export'):
            if args.store_pcl:
                logger.save_pickle(self.pcl_all, f'pcl_io_s{cur_step}.p',
                                   folder=self.log_folder)
            if args.store_activations and self.activations:
                logger.save_pickle(self.activations, f'activations_s{cur_step}.p',
                                   folder=self.log_folder)
        self.pcl_all = []
        self.activations = []

        logger.report_scalar('test/pcl_input_size', pcl_input.shape[0],
                             step=cur_step)
        logger.report_scalar('test/pcl_output_size',
                             inf['output_solid'].shape[0], step=cur_step)
        logger.report_scalar('test/air_output_size',
                             inf['output_air'].shape[0], step=cur_step)
        logger.report_histogram('test/features_global', inf['features_global'],
                                step=cur_step)
        with self.timer.phase('export'):
            logger.save_pickle((meta, cam_RT, cam_K),
                               f'metadata_s{cur_step}.p',
                               folder=self.log_folder)
        now = time.time()
        self.scene_walls.append(now - self.scene_t_last)
        self.scene_t_last = now
        logger.info(f'[test] scene step {cur_step} complete '
                    f'({self.scene_walls[-1]:.1f}s)')


class _PostWorker:
    '''Single worker thread draining a bounded queue of _FramePost calls: the
    pipelined eval's host lane. Bounded at 2 pending frames so at most ~3
    frames of dense decode output are alive at once. A worker exception is
    re-raised on the main thread at the next submit/join.

    On CUDA the current device and stream are per thread: the worker takes
    the creating thread's device and a stream of its own. Each task carries
    an event recorded on the submitting thread's current stream, and the
    worker's stream waits for it: a frame's copies to the host and its
    nn1_direct launches queue behind the kernels whose outputs they read, not
    behind the next frame's. The copies are synchronous, so a frame's device
    outputs are read before the worker drops them.'''

    def __init__(self, post, device):
        import queue
        import threading
        self.post = post
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == 'cuda' else None
        self.q = queue.Queue(maxsize=2)
        self.err = None
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name='o4d-eval-post')
        self.thread.start()

    def _loop(self):
        if self.stream is None:
            return self._drain()
        torch.cuda.set_device(self.stream.device)
        with torch.cuda.stream(self.stream):
            return self._drain()

    def _drain(self):
        while True:
            task = self.q.get()
            try:
                if task is None:
                    return
                kind, ready, task_args = task
                if ready is not None:
                    self.stream.wait_event(ready)
                getattr(self.post, kind)(*task_args)
            except BaseException as e:  # surfaced on the main thread.
                if self.err is None:
                    self.err = e
            finally:
                self.q.task_done()

    def _check(self):
        if self.err is not None:
            err, self.err = self.err, None
            raise RuntimeError('eval post worker failed') from err

    def submit(self, kind, *task_args):
        self._check()
        ready = None
        if self.stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        self.q.put((kind, ready, task_args))

    def join(self):
        self.q.put(None)
        self.thread.join()
        self._check()


def run_test(args: TestConfig, engine, data_kind, loader, logger):
    '''Main eval loop. --save_metrics scores every predicted frame with
    evaluate.metrics and writes metrics.json (with the loop's phase_split_s
    and scene_wall_s); --store_activations exports the scene's frames'
    predicted-solid activations as activations_s{step}.p.

    With --eval_overlap (default), the loop is a two-stage pipeline: this
    thread runs dispatch_inference (track set, query gen, encode/decode
    kernel launches) and a post worker thread runs everything host-bound
    (finish_inference's fetch to the host + merge + 1-NN, metrics,
    histograms, pickle export) - so frame i's host work hides under frame
    i+1's device work.'''
    from .inference import dispatch_inference
    from ..utils.profiling import PhaseTimer
    rng = np.random.RandomState(args.seed)
    start = time.time()
    # Per-phase wall split of the production eval loop (data / device infer /
    # host 1-NN / metrics / export) — readable afterwards via
    # logger.last_eval_timer and summarized into metrics.json (rounded to
    # the millisecond there). In pipelined mode the post phases (finish_wall,
    # metrics, export, ...) overlap the main thread's dispatch phase, so the
    # phase totals can legitimately sum past the loop's wall-clock.
    timer = PhaseTimer()
    logger.last_eval_timer = timer

    post = _FramePost(args, engine, data_kind, logger, timer)
    worker = (_PostWorker(post, engine.device) if getattr(args, 'eval_overlap', True)
              else None)
    submit = (worker.submit if worker is not None
              else lambda kind, *a: getattr(post, kind)(*a))

    try:
        batches = iter(loader.epoch(0))
        for cur_step in range(10 ** 9):
            with timer.phase('data'):
                batch = next(batches, None)
            if batch is None:
                break
            if cur_step == 0:
                logger.info(
                    f'First data iteration took {time.time() - start:.3f}s')
            meta = batch['meta_data'][0]
            pcl_input = batch['pcl_input'][0]
            pcl_input_sem = batch['pcl_input_sem'][0]
            pcl_target = batch['pcl_target'][0]            # (T, M, E).
            tgt_valid = batch['pcl_target_valid'][0]
            num_frames = pcl_target.shape[0]
            sem_for_inference = (pcl_input_sem if args.track_mode != 'none'
                                 else None)

            for time_idx in range(num_frames):
                tgt_frame = pcl_target[time_idx][tgt_valid[time_idx]]

                with timer.phase('dispatch_wall'):
                    pending = dispatch_inference(
                        pcl_input, sem_for_inference, engine,
                        args.min_z, args.cr_cube_bounds, args.color_mode,
                        time_idx,
                        sample_implicit=args.sample_implicit,
                        num_sample=args.num_sample,
                        point_sample_mode=args.point_sample_mode,
                        track_mode=args.track_mode,
                        data_kind=data_kind,
                        cube_mode=args.cube_mode, rng=rng)
                submit('frame', cur_step, time_idx, pending, tgt_frame,
                       pcl_input, pcl_input_sem)

            submit('scene_end', cur_step, meta, batch.get('cam_RT'),
                   batch.get('cam_K'), pcl_input)
    finally:
        if worker is not None:
            worker.join()
    all_metrics, n_reruns = post.all_metrics, post.n_reruns

    timer.report(logger, prefix='[test] ')
    if args.save_metrics and all_metrics:
        import json
        # Union of keys across frames: a frame can lack a metric entirely
        # (e.g. color_mae when it predicted no color-valid solids), not just
        # carry NaN for it.
        keys = sorted({k for m in all_metrics for k in m
                       if k not in ('step', 'time_idx')})
        agg = {}
        for k in keys:
            vals = [m[k] for m in all_metrics if k in m and np.isfinite(m[k])]
            if vals:
                agg[k] = float(np.mean(vals))
        summary = dict(mean=agg, per_frame=[
            {k: (float(v) if np.isfinite(v) else None) for k, v in m.items()}
            for m in all_metrics])
        summary['phase_split_s'] = {k: round(v[0], 3)
                                    for k, v in timer.summary().items()}
        summary['track_reruns_mean'] = (float(np.mean(n_reruns))
                                        if n_reruns else 0.0)
        summary['scene_wall_s'] = [round(w, 2) for w in post.scene_walls]
        fp = os.path.join(logger._artifact_dir('pickle', post.log_folder),
                          'metrics.json')
        with open(fp, 'w') as f:
            json.dump(summary, f, indent=2, sort_keys=True)
        logger.info('metrics: ' + ', '.join(f'{k}={v:.4f}'
                                            for k, v in sorted(agg.items())))
        for k, v in agg.items():
            logger.report_scalar(f'test/{k}', v)
        return summary
    return None


def main(args: TestConfig, logger=None, device='cuda', devices=None):
    '''CLI entry: load the checkpoint on `device` ('cuda' raises without a
    card; the tests pass 'cpu'), build the test loader and the engine, run
    the loop. The engine shards each decode chunk's queries over the devices
    of args.query_parallel (InferenceEngine), or over `devices` where given
    (e.g. ['cuda:0', 'cuda:0']); the loop, the loader and the metrics stay
    in this process. :return run_test's summary (metrics.json) or None.'''
    dev = resolve_device(device)
    # Logger roots at the run's log dir; artifacts go to its test_<tag> subfolder
    # via run_test's folder= argument.
    logger = logger or StepLogger(
        log_dir=args.log_path if args.log_path not in ('', 'auto') else None,
        context='test')
    logger.info(f'Args: {args}')
    host = native.status()
    if not host['library']:
        logger.warning('native host ops unavailable; the data plane and metrics run '
                       f'their numpy fallbacks: {host["error"]}')
    elif not host['png']:
        logger.info('fused PNG decode not built (no zlib headers); frames decode '
                    'through data/png.py and the native frame pass')
    np.random.seed(args.seed)

    loaded = load_models(args.resume, epoch=args.epoch, device=dev, logger=logger)
    args.test_tag += f'_e{loaded["epoch"]}'
    backfill_from_train(args, loaded['train_config'])

    data_kind, loader = create_test_loader(args, dict(loaded['dset_args'] or {}),
                                           logger)
    if loaded['data_kind'] is not None:
        assert data_kind == loaded['data_kind'], 'checkpoint/dataset kind mismatch'

    engine = InferenceEngine(
        loaded, color_mode=args.color_mode,
        predict_segmentation=args.segmentation_lw > 0.0,
        semantic_classes=args.semantic_classes, track_mode=args.track_mode,
        implicit_batch_size=args.implicit_batch_size,
        query_parallel=args.query_parallel,
        precision=args.eval_precision, devices=devices,
        store_activations=args.store_activations)
    logger.info(f'Eval precision: {engine.precision} (--eval_precision '
                f'{args.eval_precision}), devices {[str(d) for d in engine.devices]}')

    logger.use_wandb = logger.use_wandb or args.use_wandb
    logger.init_wandb('occlusions-4d_test', args)
    logger.info(f'Final test args: {args}')
    return run_test(args, engine, data_kind, loader, logger)


if __name__ == '__main__':
    main(test_args())
