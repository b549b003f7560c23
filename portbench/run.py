'''
The benchmark's command: one run of one cell.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It needs a CUDA card (exit 3 without as many as the cell asks for), prints
the card's name, clocks and power on standard error, runs the cell's driver
(set-up, warm-up, the measured or traced window, then the check against the
plain reference), and prints as the last line of standard output one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer metrics), device, with --trace 1 breakdown,
and last the numbers the check compared beside their limits, which also
close standard error. A run that has loaded JAX or the JAX package prints
no result (exit 4).
'''

import argparse
import json
import math
import os
import subprocess
import sys
import time
import types

from . import compare, guard, registry


def process_start(fallback):
    '''Wall-clock time at which this process started (Linux /proc), else
    `fallback`.'''
    try:
        with open('/proc/self/stat') as f:
            ticks = float(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/stat') as f:
            btime = next(float(line.split()[1]) for line in f if line.startswith('btime'))
        start = btime + ticks / os.sysconf('SC_CLK_TCK')
        return start if abs(start - fallback) < 60 else fallback
    except (OSError, ValueError, IndexError, StopIteration):
        return fallback


def parse_args(argv):
    p = argparse.ArgumentParser(prog='python3 -m portbench', description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_status():
    '''One line of nvidia-smi: name, SM clock, power draw and limit.'''
    try:
        res = subprocess.run(['nvidia-smi', '--query-gpu=name,clocks.sm,clocks.max.sm,'
                              'power.draw,power.limit,temperature.gpu',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f'nvidia-smi unavailable: {e}'


def keep_caches_in(root):
    '''The program's build and kernel caches at fixed paths in the checkout:
    the port builds its kernels into occlusions4d_torch/_build/ there; the
    CUDA JIT cache goes beside it.'''
    os.environ['CUDA_CACHE_PATH'] = os.path.join(root, '.portbench_cache', 'cuda')


def context(bench, cell, seed, seconds, trace, device, t_start):
    return types.SimpleNamespace(
        bench=bench, cell=cell, config=registry.config(cell['config']),
        mix=registry.mix(cell['traffic']), limits=registry.limits(cell['name']),
        work=registry.work(cell['config']), peaks=registry.peaks(), seed=seed,
        seconds=seconds, trace=bool(trace), device=device, t_start=t_start)


def layer_metrics(bench, ctx, data):
    '''The cell's per-layer metrics that their readers found, in order.'''
    data = dict(data, config=ctx.config, peaks=ctx.peaks)
    out = {}
    for m in registry.per_layer_for(bench, ctx.cell['name']):
        value = registry.metric_reader(m['name'])(data)
        if value is not None:
            out[m['name']] = dict(value=value, unit=m['unit'])
    return out


def result(bench, ctx, run, device):
    '''The result line's object, and whether the check held.'''
    rows, ok = compare.checks(run['readings'], ctx.limits)
    ok = ok and run['failed'] == 0 and run['attempted'] > 0
    units = {m['name']: m['unit'] for m in bench['end_to_end']}
    if ctx.trace:
        metrics = layer_metrics(bench, ctx, run['layer'])
        device = dict(device, busy_s=run['busy_s'], window_s=run['window_s'])
    else:
        values = dict(run['end_to_end'], setup_s=run['setup_s'])
        metrics = {m['name']: dict(value=values[m['name']], unit=units[m['name']])
                   for m in registry.end_to_end_for(bench, ctx.cell['name'])}
    line = dict(correct=bool(ok), attempted=run['attempted'], failed=run['failed'],
                metrics=metrics, device=device)
    if ctx.trace:
        line['breakdown'] = run['breakdown']
    # A number that is not finite (a NaN output) is written as null.
    line['checks'] = {r['name']: dict(value=r['value'] if math.isfinite(r['value']) else None,
                                      limit=r['limit']) for r in rows}
    return line, rows


def main(argv, t0=None):
    args = parse_args(argv)
    t_start = process_start(time.time() if t0 is None else t0)
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    keep_caches_in(registry.ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell['chips']:
        print(f'portbench: {args.workload} needs {cell["chips"]} CUDA card(s); '
              f'torch.cuda.is_available() is {torch.cuda.is_available()}, '
              f'device_count() {torch.cuda.device_count()}', file=sys.stderr)
        return 3
    print(f'portbench: card {card_status()}', file=sys.stderr, flush=True)
    ctx = context(bench, cell, args.seed, args.seconds, args.trace, 'cuda', t_start)
    run = registry.driver(ctx.mix['driver']).run(ctx)
    device = dict(platform='gpu', kind=torch.cuda.get_device_name(0), count=cell['chips'],
                  memory_peak_bytes=run['memory_peak_bytes'])
    line, rows = result(bench, ctx, run, device)
    print(f'portbench: card {card_status()}', file=sys.stderr)
    print(f'portbench: set-up {run["setup_s"]:.2f} s, window {run["window_wall_s"]:.2f} s, '
          f'check {run["check_s"]:.2f} s', file=sys.stderr)
    if run.get('item_s'):
        t = sorted(run['item_s'])
        print(f'portbench: items {len(t)}, s each: min {t[0]:.4f} median {t[len(t) // 2]:.4f} '
              f'max {t[-1]:.4f}', file=sys.stderr)
    found = guard.forbidden_modules()
    if found:
        print(f'portbench: the run loaded {", ".join(found)}: no result', file=sys.stderr)
        return 4
    for r in rows:
        print(f'check {r["name"]} {r["value"]!r} limit {r["limit"]!r}', file=sys.stderr)
    print(f'check correct {line["correct"]}', file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
