#!/usr/bin/env python3
'''
The eval driver's pipelined loop (--eval_overlap true, the default) against
its serial loop, on one NVIDIA GPU.

    python3 tools/eval_overlap.py [--anchor_rounds 2] [--gv1_steps 1]

Three loops over the same frames: 'serial' (--eval_overlap false),
'overlap' (the post worker on a stream of its own that waits for each
frame's kernels by an event) and 'overlap_same_stream' (the worker on the
main thread's stream, the design it replaced: a frame's copies to the host
queue behind the next frame's kernels). They run in the order A B C C B A,
repeated, so that no loop holds the first call alone: on the committed
GREATER anchor (tests/anchor_recipe.py, f32, 3 steps, test_driver.main) and
on gv1 at full width (chip_smoke.py's gv1_eval_setup: seeded weights,
524288 grid queries, --save_metrics; run_test). Each run prints a JSON line
(wall, per-frame wall, phase split); then a summary per target (walls per
loop, their means, each loop's mean over the serial one's, whether the
per-frame metrics are the same bit for bit), the card's nvidia-smi name and
power limit. Lines also go to chiprun_out/eval_overlap.jsonl. Needs CUDA;
imports nothing of JAX.
'''

import argparse
import json
import os
import shutil
import sys
import tempfile

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LOOPS = ('serial', 'overlap', 'overlap_same_stream')


def same_stream_worker(torch, test_driver):
    '''The post worker as first written: the submitting thread's current
    stream and no events.'''
    class SameStreamWorker(test_driver._PostWorker):
        def __init__(self, post, device):
            self.main = torch.cuda.current_stream(device)
            super().__init__(post, device)

        def _loop(self):
            torch.cuda.set_device(self.main.device)
            with torch.cuda.stream(self.main):
                return self._drain()

        def submit(self, kind, *task_args):
            self._check()
            self.q.put((kind, None, task_args))
    return SameStreamWorker


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--anchor_rounds', type=int, default=2)
    ap.add_argument('--gv1_steps', type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('needs CUDA', file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    sys.path.append(os.path.join(_ROOT, 'tests'))
    import anchor_recipe
    import chip_smoke as cs
    from occlusions4d_torch.evaluate import test_driver
    dev = torch.device('cuda')
    smi = cs.nvidia_smi()
    os.makedirs(os.path.join(_ROOT, 'chiprun_out'), exist_ok=True)
    out = open(os.path.join(_ROOT, 'chiprun_out', 'eval_overlap.jsonl'), 'w')

    def emit(d):
        line = json.dumps(d)
        print(line, flush=True)
        out.write(line + '\n')
        out.flush()

    default_worker = test_driver._PostWorker
    same_worker = same_stream_worker(torch, test_driver)

    def run(target, loop, fn):
        test_driver._PostWorker = same_worker if loop == 'overlap_same_stream' \
            else default_worker
        try:
            summary, _, wall, split = fn('false' if loop == 'serial' else 'true')
        finally:
            test_driver._PostWorker = default_worker
        frames = len(summary['per_frame'])
        emit(dict(target=target, loop=loop, frames=frames, wall_s=wall,
                  frame_wall_s=wall / frames, phase_split_s=split,
                  device_infer_share=split.get('device_infer', 0.0) / wall))
        return wall, summary['per_frame']

    def compare(target, fn, rounds):
        order = (list(_LOOPS) + list(reversed(_LOOPS))) * rounds
        walls = {loop: [] for loop in _LOOPS}
        frames = {}
        for loop in order:
            wall, per_frame = run(target, loop, fn)
            walls[loop].append(wall)
            frames.setdefault(loop, per_frame)
        mean = {loop: sum(w) / len(w) for loop, w in walls.items()}
        emit(dict(target=target, summary=True, order=order, walls_s=walls, mean_wall_s=mean,
                  over_serial={loop: mean[loop] / mean['serial'] for loop in _LOOPS},
                  bit_identical=all(frames[loop] == frames['serial'] for loop in _LOOPS),
                  gpu=smi))

    tmp = tempfile.mkdtemp(prefix='o4d_overlap_')
    try:
        data = anchor_recipe.make_scene('greater', os.path.join(tmp, 'anchor'))
        n = [0]

        def anchor(ov):
            n[0] += 1
            log = os.path.join(tmp, 'anchor', f'run{n[0]}', 'anchor')
            argv, _ = anchor_recipe.eval_argv('greater', data, log,
                                              ('--eval_precision', 'auto', '--eval_overlap', ov))
            return cs.run_driver(torch, argv, log)
        compare('greater_anchor', anchor, args.anchor_rounds)

        gv = cs.gv1_eval_setup(torch, dev, os.path.join(tmp, 'gv1'), steps=args.gv1_steps)
        emit(dict(target='gv1', input_points_before_padding=gv['sizes'],
                  scene_gen_s=gv['scene_gen_s']))
        compare('gv1', lambda ov: cs.run_gv1(torch, gv, eval_overlap=ov == 'true'), 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        out.close()
    print(smi, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
