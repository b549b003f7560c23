'''
The train driver: a closed loop of training steps through the user's epoch
loop, Trainer.run_epoch, fed by an iterable of host numpy batches.

Mix parameters (mixes/<name>.json):
  pool          distinct batches made from the seed (inputs.train_batch),
                cycled;
  target_factor target points a frame per input point;
  first_steps   the set-up's first steps: one run_epoch (epoch 0) over the
                pool's first batches, each distinct. They warm every shape
                up and are the steps the check holds against the reference;
  trace_steps   steps in the traced sub-window of a --trace 1 run.

The window is one run_epoch (epoch 1) of the same Trainer over the cycled
pool; its feed stops once `seconds` have passed. step_ms is the window's
wall time, from its first step to a synchronize after its last, over the
steps it ran; peak_mem_gib the allocator's peak over the window. The logger
has no log directory (no exports, no visuals); LOG_EVERY's host read stays.
'''

import dataclasses
import gc
import logging
import sys
import time

import torch

from .. import compare, inputs
from .. import profile as prof
from .. import weights as W
from ..reference import train as ref_train

ADAM_B1 = 0.9


def train_config(cfg, seed, device):
    '''The port's TrainConfig of a configuration file (its TrainConfig
    fields), seeded from the run's seed.'''
    from occlusions4d_torch.config import TrainConfig
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    fields = {k: v for k, v in cfg.items() if k in names}
    fields.update(seed=int(seed), device=str(device), output_path='')
    return TrainConfig(**fields)


def quiet_logger(batch_size):
    '''The Trainer's StepLogger without a log directory, writing to stderr
    (standard output carries the result).'''
    from occlusions4d_torch.utils.logvis import StepLogger
    logger = StepLogger(log_dir=None, context='train', batch_size=batch_size)
    for h in list(logger.logger.handlers):
        logger.logger.removeHandler(h)
    logger.logger.addHandler(logging.StreamHandler(sys.stderr))
    return logger


def first_steps(tr, pool, n):
    '''The set-up's steps: run_epoch(0) over pool[:n], recording each step's
    loss, the optimizer's first moments after the first step and the
    parameters after the last, the check's readings of the program.
    :return (losses, first moments) as device tensors.'''
    losses, mu1 = [], []
    step_fn = tr._step

    def recording(*args, **kwargs):
        m = step_fn(*args, **kwargs)
        losses.append(m['total_loss'])
        return m

    def feed():
        for i in range(n):
            if i == 1:      # step 0 is queued: its moments follow it on the stream.
                mu1.extend(m.detach().clone() for m in tr.optimizer.mu)
            yield pool[i]

    tr._step = recording
    try:
        tr.run_epoch(0, 'train', feed())
    finally:
        tr._step = step_fn
    if not mu1:
        mu1.extend(m.detach().clone() for m in tr.optimizer.mu)
    return losses, mu1


def setup(ctx):
    """The program's side of the set-up: kernels, weights, the Trainer, the
    batch pool and the first steps. :return (trainer, weights, pool, the
    program's readings of its first steps)."""
    from occlusions4d_torch.ops import _build
    from occlusions4d_torch.train import Trainer

    dev = torch.device(ctx.device)
    cfg, mix = ctx.config, ctx.mix
    if dev.type == 'cuda':
        _build.build_all()
    weights = W.make_weights(cfg, ctx.seed, dev)
    tr = Trainer(train_config(cfg, ctx.seed, dev), cfg['data_kind'], dev,
                 logger=quiet_logger(cfg['batch_size']))
    tr.init_state(seed=ctx.seed)
    W.load_into(dict(encoder=tr.encoder, decoder=tr.decoder), weights)
    pool = [inputs.train_batch(cfg, cfg['data_kind'], ctx.seed, i, mix['target_factor'])
            for i in range(mix['pool'])]
    losses, mu1 = first_steps(tr, pool, mix['first_steps'])
    names = [f'{net}.{n}' for net, n in tr._param_names]
    program = dict(
        losses=[float(x) for x in losses],
        grad_norms={n: float(m.norm()) / (1.0 - ADAM_B1) for n, m in zip(names, mu1)},
        change_norms={n: float((p.detach() - weights[n]).norm())
                      for n, p in zip(names, tr.optimizer.params)})
    return tr, weights, pool, program


def reference(ctx, weights, pool, **kwargs):
    """The reference's readings of the same first steps (reference/train.py
    run_steps; kwargs: rows, tf32)."""
    dev = torch.device(ctx.device)
    n = ctx.mix['first_steps']
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()} for b in pool[:n]]
    return ref_train.run_steps(ctx.config, ctx.config['data_kind'], weights, batches, ctx.seed,
                               dev, n_steps=n, **kwargs)


def release():
    """Return the freed program state's memory before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(ctx):
    dev = torch.device(ctx.device)
    cuda = dev.type == 'cuda'
    cfg, mix = ctx.config, ctx.mix
    tr, weights, pool, program = setup(ctx)
    n_first = mix['first_steps']
    cycle = lambda i: pool[(n_first + i) % len(pool)]  # noqa: E731
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    count0 = int(tr.optimizer.count)
    t0 = time.time()
    out = dict(setup_s=t0 - ctx.t_start)
    if not ctx.trace:
        n = 0

        def window_feed():
            nonlocal n
            while time.time() - t0 < ctx.seconds:
                n += 1
                yield cycle(n - 1)

        tr.run_epoch(1, 'train', window_feed())
        if cuda:
            torch.cuda.synchronize()
        t1 = time.time()
        applied = int(tr.optimizer.count) - count0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        out['end_to_end'] = dict(step_ms=(t1 - t0) * 1e3 / n, peak_mem_gib=peak / 2 ** 30)
    else:
        n = mix['trace_steps']
        feed = [cycle(i) for i in range(n)]
        _, summary = prof.capture(lambda: tr.run_epoch(1, 'train', iter(feed)), dev)
        applied = int(tr.optimizer.count) - count0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        split = prof.split_step(tr, cycle(n), dev)
        out.update(busy_s=summary['busy_s'], window_s=summary['window_s'],
                   breakdown=dict(device_ops=summary['device_ops'],
                                  idle_gaps=summary['idle_gaps']))
        out['layer'] = dict(items=n, trace=summary, phase_ms=split,
                            flops_per_item=ctx.work.train_step_flops(cfg),
                            attn_bwd_per_item=ctx.work.train_attention_backward(cfg))
    out.update(attempted=n, failed=n - applied,
               memory_peak_bytes=max(setup_peak, peak) if cuda else 0)

    # The check: the program's state freed, the reference follows the first
    # steps from the same weights, batches and seed.
    out['window_wall_s'] = time.time() - t0
    t_check = time.time()
    del tr
    release()
    out['readings'] = compare.train_readings(program, reference(ctx, weights, pool))
    out['check_s'] = time.time() - t_check
    return out
