#!/usr/bin/env python3
'''
Where the train driver's step wall goes on one NVIDIA GPU: the gv1 recipe
(chip_smoke.py's train_driver command line, batch 3, 14336 points) on a
synthetic GREATER train stage, one Trainer, three ways of feeding the same
train step:

  loader     Trainer.run_epoch over the Loader (its worker threads decode
             the next batches while the card trains), as train.main runs;
  preloaded  Trainer.run_epoch over batches already decoded and held in
             memory (no loader thread runs during the steps);
  bare       Trainer.step on each preloaded batch, a synchronize after each
             (the step time of PERF.md section 5).

    python3 tools/profile_train_driver.py [--steps 8] [--workers 4]
        [--profile_steps 3]

Runs them in the order loader, preloaded, bare, bare, preloaded, loader
(each --steps steps, no viz export), then the first --profile_steps steps
of loader and preloaded once more under torch.profiler for the device's
busy share (the union of the kernels' intervals over the wall). Prints the card's nvidia-smi line and one JSON
line: per run the wall per step (host clock around the epoch, then a
synchronize), the spans' host split (chip_smoke.epoch_spans), and the busy shares. Needs CUDA;
imports nothing of JAX.
'''

import argparse
import json
import logging
import os
import shutil
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def busy_share(prof, wall_ms):
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, cur = 0.0, None
    for lo, hi in spans:
        if cur is None or lo > cur[1]:
            busy_us += 0.0 if cur is None else cur[1] - cur[0]
            cur = [lo, hi]
        else:
            cur[1] = max(cur[1], hi)
    busy_us += 0.0 if cur is None else cur[1] - cur[0]
    return busy_us / 1e3 / wall_ms if spans else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=8)
    ap.add_argument('--workers', type=int, default=4)
    ap.add_argument('--profile_steps', type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('needs CUDA', file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    import chip_smoke as cs
    from occlusions4d_torch.config import train_args
    from occlusions4d_torch.data import create_train_val_loaders, synthetic
    from occlusions4d_torch.ops import _build
    from occlusions4d_torch.train import Trainer
    from occlusions4d_torch.utils.logvis import StepLogger
    from torch.profiler import ProfilerActivity, profile

    _build.build_all()
    tmp = tempfile.mkdtemp(prefix='o4d_tdprof_')
    try:
        data = os.path.join(tmp, 'data')
        synthetic.make_greater_dataset(data, **cs._TD_GV1_SCENE)
        argv = list(cs._TD_GV1_ARGV)
        argv[argv.index('--num_workers') + 1] = str(args.workers)
        argv[argv.index('--use_data_frac') + 1] = str((args.steps * 3 + 0.5) / 960)
        cfg = train_args(argv + ['--data_path', data, '--output_path', ''])
        logger = StepLogger(log_dir=None, context='train')
        for h in list(logger.logger.handlers):
            logger.logger.removeHandler(h)
        logger.logger.addHandler(logging.NullHandler())
        _, loader, _, _ = create_train_val_loaders(cfg, logger)
        tr = Trainer(cfg, 'greater', logger=logger).init_state(
            steps_per_epoch=loader.steps_per_epoch)
        preloaded = list(loader.epoch(1))
        tr.run_epoch(0, 'train', iter(preloaded[:1]))       # warm-up.
        torch.cuda.synchronize()

        def run(kind, epoch, steps=len(preloaded)):
            torch.cuda.synchronize()
            t0 = time.time()
            if kind == 'bare':
                for b in preloaded[:steps]:
                    tr.step(b)
                    torch.cuda.synchronize()
                split = None
            else:
                _, _, _, split = cs.epoch_spans('train', lambda: tr.run_epoch(
                    epoch, 'train', loader.epoch(epoch) if kind == 'loader'
                    else iter(preloaded), num_steps=steps))
            torch.cuda.synchronize()
            wall = time.time() - t0
            return dict(kind=kind, epoch=epoch, steps=steps, wall_s=wall,
                        wall_ms_per_step=1e3 * wall / steps, split_s=split)

        runs = [run(kind, e) for e, kind in
                enumerate(('loader', 'preloaded', 'bare', 'bare', 'preloaded', 'loader'), 2)]
        busy = {}
        for e, kind in enumerate(('loader', 'preloaded'), 10):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         acc_events=True) as prof:
                r = run(kind, e, args.profile_steps)
            busy[kind] = dict(wall_ms_per_step=r['wall_ms_per_step'],
                              device_busy_share=busy_share(prof, 1e3 * r['wall_s']))
        mean = {k: sum(r['wall_ms_per_step'] for r in runs if r['kind'] == k) / 2
                for k in ('loader', 'preloaded', 'bare')}
        print(cs.nvidia_smi(), flush=True)
        print(json.dumps(dict(model='gv1', batch_size=cfg.batch_size, n_points=cfg.n_points,
                              workers=cfg.num_workers, steps=len(preloaded), runs=runs,
                              mean_wall_ms_per_step=mean, profiled=busy)), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
