'''
The rank functions of tests/test_torch_parallel.py, and the fixed
supervision its lockstep and chip_smoke.py's train_data_parallel phase
share. parallel.spawn's processes import this module by name, so it imports
no JAX: each rank function runs one rank of a 2-rank gloo group on the CPU
and rank 0 pickles what the test compares into spec['out'].
'''

import os
import pickle

import numpy as np
import torch

from occlusions4d_torch import parallel
from occlusions4d_torch import train as t_train
from occlusions4d_torch.config import train_args
from occlusions4d_torch.data import loader as t_loader
from occlusions4d_torch.models import factory as t_factory
from occlusions4d_torch.models import layers as t_layers
from occlusions4d_torch.utils.logvis import StepLogger

# valo_ids[:, 0] of an example whose frame 0 the fixed sampler marks not ok.
DROP = -7


def supervision(T, n_q, half, seed=3):
    '''Fixed (queries, targets) per frame exercising every loss mask
    (tests/test_torch_train.py's _supervision, whose queries span half 2):
    queries in [-half, half]^3, mixed solid/air density, ~30% colour-
    unavailable rows, track in {-1, 0, 1}, segm in [-1, 13).'''
    rng = np.random.RandomState(seed)
    q = np.concatenate([(rng.rand(T, n_q, 3) * 2 * half - half).astype(np.float32),
                        np.tile(np.arange(T, dtype=np.float32)[:, None, None],
                                (1, n_q, 1))], axis=-1)
    tgt = np.zeros((T, n_q, 6), np.float32)
    tgt[..., 0] = (rng.rand(T, n_q) < 0.5).astype(np.float32)
    rgb = rng.rand(T, n_q, 3).astype(np.float32)
    rgb[rng.rand(T, n_q) < 0.3] = -1.0
    tgt[..., 1:4] = rgb
    track = (rng.rand(T, n_q) < 0.5).astype(np.float32)
    tgt[..., 4] = np.where(rng.rand(T, n_q) < 0.25, -1.0, track)
    tgt[..., 5] = rng.randint(-1, 13, (T, n_q))
    return q, tgt


class FixedSampler:
    '''Fixed supervision for the port's batched sampler, every example
    alike, on the batch's device; frame 0 of an example whose
    valo_ids[:, 0] is DROP is not ok (the ok flags then differ between the
    ranks).'''

    def __init__(self, queries, targets, n_solid):
        self.q, self.t, self.n_solid = queries, targets, n_solid

    def sample_frame(self, gen, tgt, tgt_valid, other, other_valid, valo_ids,
                     num_valo_ids, time_idx):
        B, t, S, dev = tgt.shape[0], int(time_idx), self.n_solid, tgt.device
        q = torch.tensor(self.q[t], device=dev)[None].expand(B, -1, -1)
        tg = torch.tensor(self.t[t], device=dev)[None].expand(B, -1, -1)
        ok = torch.ones((B,), dtype=torch.bool, device=dev)
        if t == 0:
            ok = valo_ids[:, 0] != DROP
        return dict(solid_input=q[:, :S], air_input=q[:, S:], solid_target=tg[:, :S],
                    air_target=tg[:, S:], solid_sbs=torch.zeros((B, 6), device=dev),
                    air_sbs=torch.zeros((B, 4), device=dev), ok=ok)


def no_random_fps():
    '''FPS from point 0 (the JAX package draws its starts from another
    stream), as tests/test_torch_train_driver.py sets it.'''
    orig = t_factory.build_encoder_args
    t_factory.build_encoder_args = lambda *a: dict(orig(*a), fps_random_start=False)


def quiet_logger(name):
    logger = StepLogger(context=name)
    logger.logger.setLevel(40)
    return logger


def named_numpy(tr):
    '''{'net.param': array} of a Trainer's parameters and buffers.'''
    return {f'{net}.{k}': v.detach().numpy().copy() for net, m in tr._nets.items()
            for k, v in m.state_dict().items()}


def flat_grads(tr, batch, group, per_rank_mean=False):
    '''The train step's gradients of one batch (this rank's rows) summed
    over the group, and the logged losses. per_rank_mean: the naive variant,
    each rank's own weighted mean, the gradients and losses averaged.'''
    pipe = tr.pipeline
    if per_rank_mean:
        pipe.group = None
    loss, (losses, aux) = pipe.loss(t_train._to_device(batch, tr.device),
                                    torch.Generator().manual_seed(0))
    t_layers.take_batch_stats(tr.encoder)
    grads = torch.autograd.grad(loss, tr.optimizer.params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(tr.optimizer.params,
                                                                     grads)]
    grads = parallel.all_reduce_flat(grads, group)
    if per_rank_mean:
        pipe.group = group
        grads = [g / group.size for g in grads]
        logged = {k: float(parallel.all_reduce_sum(v.detach(), group)) / group.size
                  for k, v in losses.items()}
    else:
        logged = {k: float(v.detach()) for k, v in aux.get('global_losses', losses).items()}
    return torch.cat([g.reshape(-1) for g in grads]).numpy(), logged


def _trainer(spec, group, name):
    no_random_fps()
    t_train.LOG_EVERY = 1
    cfg = train_args(spec['argv'])
    cfg.output_path, cfg.device = '', 'cpu'
    return t_train.Trainer(cfg, 'greater', logger=quiet_logger(name), group=group)


def _dump(spec, group, obj):
    if group.is_main:
        with open(spec['out'], 'wb') as f:
            pickle.dump(obj, f)


def lockstep_rank(group, spec):
    '''3 train steps over two epochs (the LR boundary at step 2) on the
    global batches, then the unequal-ok batch's gradients both ways.'''
    tr = _trainer(spec, group, 'lock')
    tr.init_state(params=spec['init'], steps_per_epoch=2)
    tr.pipeline.sampler = FixedSampler(*spec['sup'], 48)
    batches = spec['batches'] if group.is_main else None
    hist, params = [], []
    for epoch, sl in ((0, slice(0, 2)), (1, slice(2, 3))):
        hist.append(tr.run_epoch(epoch, 'train', batches[sl] if batches else None))
        params.append(named_numpy(tr))
    lrs = [float(tr.optimizer.lr(torch.tensor(c))) for c in range(3)]
    steps = tr.step_count
    tr.init_state(params=spec['init'], steps_per_epoch=2)
    tr.pipeline.sampler = FixedSampler(*spec['sup'], 48)
    local = parallel.shard_rows(spec['uneven'], group.rank, group.size)
    ok_local = int((np.asarray(local['valo_ids'])[:, 0] != DROP).sum())
    grads, logged = flat_grads(tr, local, group)
    naive, naive_logged = flat_grads(tr, local, group, per_rank_mean=True)
    oks = [None] * group.size
    torch.distributed.all_gather_object(oks, ok_local)
    _dump(spec, group, dict(hist=hist, params=params, lrs=lrs, grads=grads, logged=logged,
                            naive=naive, naive_logged=naive_logged, ok_per_rank=oks,
                            steps=steps))


def batchnorm_rank(group, spec):
    '''One train step from each of JAX's states (its pkl files: params with
    batch_stats, moments, count) on this rank's rows; then, from the first,
    the gradients with the statistics' all-reduce and with a forward-only
    one.'''
    tr = _trainer(spec, group, 'bn')
    local = parallel.shard_rows(spec['batch'], group.rank, group.size)
    steps = []
    for path in spec['states']:
        tr.resume(path, steps_per_epoch=1000)
        tr.pipeline.sampler = FixedSampler(*spec['sup'], 48)
        m = tr.step(local)
        steps.append(dict(metrics={k: np.asarray(t_train._numpy(v)) for k, v in m.items()},
                          state=named_numpy(tr)))
    tr.resume(spec['states'][0], steps_per_epoch=1000)
    tr.pipeline.sampler = FixedSampler(*spec['sup'], 48)
    grads, _ = flat_grads(tr, local, group)

    class ForwardOnly:
        '''The trap: the statistics summed forward, each rank's backward
        left with the gradient of its own rows.'''

        @staticmethod
        def apply(t):
            return t + (parallel.all_reduce_sum(t, group) - t).detach()

    orig, t_layers.AllReduceSum = t_layers.AllReduceSum, ForwardOnly
    try:
        fwd_only, _ = flat_grads(tr, local, group)
    finally:
        t_layers.AllReduceSum = orig
    _dump(spec, group, dict(steps=steps, grads=grads, fwd_only=fwd_only))


def data_rank(group, spec):
    '''(a) each rank's rows of 2 epochs of the train loader read on rank 0;
    (b) a run_epoch whose second batch fails on rank 1 only (its host-side
    copy raises);
    (c) a 2-epoch run through train._run with checkpoints, then a run
    resumed from its model_0.pkl, then the 2-epoch run again with rank 0's
    loaders on fork workers (--worker_mode process).'''
    out = {}
    cfg = train_args(spec['loader_argv'])
    logger = quiet_logger('data')
    loader = t_loader.create_train_val_loaders(cfg, logger)[1] if group.is_main else None
    rows = []
    for epoch in (0, 1):
        rows.append(list(parallel.rank_batches(loader.epoch(epoch) if loader else None,
                                                group)))
    gathered = [None] * group.size
    torch.distributed.all_gather_object(gathered, rows)
    out['rows'] = gathered

    tr = _trainer(spec, group, 'err')
    errors = []
    tr.logger.exception = lambda e: errors.append(repr(e))
    tr.init_state(seed=0, steps_per_epoch=4)
    orig_to_device, calls = t_train._to_device, []

    def failing_to_device(batch, dev):
        calls.append(1)
        if group.rank == 1 and len(calls) == 2:
            raise ValueError('a host-side data error on rank 1')
        return orig_to_device(batch, dev)

    t_train._to_device = failing_to_device
    tr.run_epoch(0, 'train', spec['err_batches'] if group.is_main else None)
    t_train._to_device = orig_to_device
    report = [None] * group.size
    torch.distributed.all_gather_object(report, dict(errors=errors, steps=tr.step_count))
    out['err'] = report

    saves = []
    orig = t_train.save_checkpoint

    def counted(*a, **k):
        saves.append(a[1])
        return orig(*a, **k)

    t_train.save_checkpoint = counted
    no_random_fps()
    cfg = train_args(spec['run_argv'])
    full = t_train._run(group, cfg, quiet_logger('full'))
    cfg = train_args(spec['run_argv'] + ['--resume', os.path.join(cfg.output_path,
                                                                  'model_0.pkl')])
    cfg.output_path = spec['resumed_out']
    resumed = t_train._run(group, cfg, quiet_logger('resumed'))
    t_train.save_checkpoint = orig
    cfg = train_args(spec['run_argv'] + ['--worker_mode', 'process', '--num_workers', '2'])
    cfg.output_path = spec['process_out']
    process = t_train._run(group, cfg, quiet_logger('process'))
    per_rank = [None] * group.size
    torch.distributed.all_gather_object(per_rank, saves)
    out['saves'] = per_rank
    for name, tr in (('full', full), ('resumed', resumed), ('process', process)):
        out[name] = dict(state=named_numpy(tr), count=int(tr.optimizer.count),
                         mu=[m.numpy().copy() for m in tr.optimizer.mu],
                         nu=[v.numpy().copy() for v in tr.optimizer.nu],
                         step_count=tr.step_count, start_epoch=tr.start_epoch,
                         scalars=tr.logger.scalar_history)
    _dump(spec, group, out)
