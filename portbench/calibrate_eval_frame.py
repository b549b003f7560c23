'''
The readings that the limits of a cell of the eval_frame driver are set from
(calibrate.py's counterpart for that driver, whose cells it does not run),
on the card at the cell's own size, in one process:

  program  the program's numbers against the reference on each seed, as a
           run's check takes them, over the first compare_frames frames
           after the warm-up;
  control  the reference put in the program's place in the nearest
           precision below the configuration's (TF32 products for f32, the
           metrics' 1-NN distances from TF32 products), against the
           reference.

    python3 -m portbench.calibrate_eval_frame --workload gv1.eval_frame
        --seeds 1,2,3 [--control-seeds 4,5,6]

One JSON line a reading on standard output.
'''

import argparse
import json
import shutil
import sys
import time

from . import registry
from .calibrate import _seeds
from .drivers import eval_frame
from .drivers.train import release
from .run import context


def readings(ctx, program, control):
    engine, weights, args, source, root = eval_frame.setup(ctx)
    try:
        k = ctx.mix['compare_frames']
        summary, batches, outputs = eval_frame.run_frames(ctx, engine, args, source, root,
                                                          count=k)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del engine
    release()
    results = eval_frame.results_of(summary, batches, outputs)
    out = {}
    if program:
        out['program'] = eval_frame.reference(ctx, weights, results, sorted(results))
    if control:
        out['control'] = eval_frame.reference(ctx, weights, results, sorted(results), tf32=True)
    out['metrics'] = [results[i]['metrics'] for i in sorted(results)]
    return out


def main(argv):
    p = argparse.ArgumentParser(prog='python3 -m portbench.calibrate_eval_frame')
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=_seeds, default=[])
    p.add_argument('--control-seeds', type=_seeds, default=[])
    args = p.parse_args(argv)
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        ctx = context(bench, cell, seed, 0.0, 0, 'cuda', time.time())
        t0 = time.time()
        res = readings(ctx, seed in args.seeds, seed in args.control_seeds)
        print(json.dumps(dict(workload=args.workload, seed=seed, seconds=time.time() - t0,
                              **res)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
