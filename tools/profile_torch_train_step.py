#!/usr/bin/env python3
'''
Device-time breakdown of one gv1 train step of the PyTorch/CUDA port on one
NVIDIA GPU, with torch.profiler.

    python3 tools/profile_torch_train_step.py [--steps 1]

Builds the gv1 train configuration and batch exactly as chip_smoke.py's train
phase does (seeded numpy weights, bench.py-shaped synthetic batch, batch 3,
4 frames), runs one warm-up step, then profiles --steps steps and prints one
JSON line: wall ms per step, summed kernel ms per step, the device busy and
idle shares (the union of the kernels' intervals over the wall time), and
the kernels grouped by name with their share of kernel time. Also prints the card's
nvidia-smi name and power limit. Needs CUDA; imports nothing of JAX.
'''

import argparse
import json
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('needs CUDA', file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    import chip_smoke as cs
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.train import Trainer
    from torch.profiler import ProfilerActivity, profile

    cfg = TrainConfig(**cs._GV1_TRAIN)
    tr = Trainer(cfg, 'greater', 'cuda')
    rng = np.random.RandomState(2)
    tr.init_state(params=dict(encoder=cs.random_jax_params(tr.encoder, rng),
                              decoder=cs.random_jax_params(tr.decoder, rng)),
                  seed=0, steps_per_epoch=100)
    batch = cs.train_batch(torch, cfg, torch.device('cuda'))
    tr.step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.time()
        for _ in range(args.steps):
            tr.step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / args.steps
    # Kernel events only (CPU-side ops also report their kernels' device
    # time); the busy share is the union of the kernels' intervals.
    from torch.autograd import DeviceType
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    spans = []
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / args.steps
        spans.append((e.time_range.start, e.time_range.end))
    busy_us, cur = 0.0, None
    for lo, hi in sorted(spans):
        if cur is None or lo > cur[1]:
            if cur is not None:
                busy_us += cur[1] - cur[0]
            cur = [lo, hi]
        else:
            cur[1] = max(cur[1], hi)
    if cur is not None:
        busy_us += cur[1] - cur[0]
    busy_ms = busy_us / 1e3 / args.steps
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(cs.nvidia_smi(), flush=True)
    print(json.dumps(dict(
        model='gv1', batch_size=cfg.batch_size, frames=cfg.past_frames, steps=args.steps,
        wall_ms_per_step=wall_ms, device_ms_per_step=device_ms,
        device_busy_ms_per_step=busy_ms, device_busy_share=busy_ms / wall_ms,
        device_idle_share=1.0 - busy_ms / wall_ms, kernel_launches=len(kernels) // args.steps,
        kernels=[dict(name=k[:120], ms=v, share=v / max(device_ms, 1e-9)) for k, v in top],
        profiler_saw_device_time=device_ms > 0)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
