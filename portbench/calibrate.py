'''
The readings that a cell's limits are set from, on the card at the cell's
own size, in one process (the benchmark's runs never run this):

  program  the program's numbers against the reference on each seed, as a
           run's check takes them (train: the first steps; scene: the first
           compare_scenes scenes, each a full grid);
  control  the reference put in the program's place in the nearest
           precision below the configuration's (TF32 products for f32),
           against the reference;
  half     (train) the reference with half of each batch left out and the
           mean taken over the rest, against the reference.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3
        [--control-seeds 4,5,6] [--half-seeds 7,8,9]

One JSON line a reading on standard output.
'''

import argparse
import json
import sys
import time

from . import compare, registry
from .drivers import scene as scene_driver
from .drivers import train as train_driver
from .run import context


def _seeds(text):
    return [int(s) for s in text.split(',') if s]


def train_readings(ctx, kinds):
    tr, weights, pool, program = train_driver.setup(ctx)
    del tr
    train_driver.release()
    ref = train_driver.reference(ctx, weights, pool)
    B = ctx.config['batch_size']
    runs = {'program': program}
    if 'control' in kinds:
        runs['control'] = train_driver.reference(ctx, weights, pool, tf32=True)
    if 'half' in kinds:
        runs['half'] = train_driver.reference(ctx, weights, pool, rows=list(range(B - B // 2)))
    out = {k: compare.train_readings(v, ref) for k, v in runs.items()}
    # Every step's loss gap, beside the first step's that the check compares.
    out['step_loss_gaps'] = {k: compare.loss_gaps(v['losses'], ref['losses'])
                             for k, v in runs.items()}
    out['losses'] = ref['losses']
    return out


def scene_readings(ctx, kinds):
    engine, weights, scene = scene_driver.setup(ctx)
    k = ctx.mix['compare_scenes']
    results = {i: scene(i) for i in range(k)}
    del engine, scene
    train_driver.release()
    out = {'program': scene_driver.reference(ctx, weights, results, range(k))}
    if 'control' in kinds:
        out['control'] = scene_driver.reference(ctx, weights, None, range(k), tf32=True)
    return out


def main(argv):
    p = argparse.ArgumentParser(prog='python3 -m portbench.calibrate')
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=_seeds, default=[])
    p.add_argument('--control-seeds', type=_seeds, default=[])
    p.add_argument('--half-seeds', type=_seeds, default=[])
    args = p.parse_args(argv)
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    seeds = list(dict.fromkeys(args.seeds + args.control_seeds + args.half_seeds))
    for seed in seeds:
        ctx = context(bench, cell, seed, 0.0, 0, 'cuda', time.time())
        kinds = {k for k, lst in (('control', args.control_seeds), ('half', args.half_seeds))
                 if seed in lst}
        t0 = time.time()
        if ctx.mix['driver'] == 'train':
            res = train_readings(ctx, kinds)
        else:
            res = scene_readings(ctx, kinds)
        if seed not in args.seeds:
            res.pop('program')
        print(json.dumps(dict(workload=args.workload, seed=seed, seconds=time.time() - t0,
                              **res)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
