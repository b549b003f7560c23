'''
Devices, process groups and collectives (port of
occlusions4d_tpu/parallel/mesh.py, the JAX package's replacement for the
reference's torch.nn.DataParallel).

The JAX package runs one controller over a 1-D 'dp' mesh: the batch's
leading axis is split over the chips, the parameters replicated, and XLA
inserts the gradient all-reduce. The port's counterparts:
  * training runs one process a device (a rank), each on its rows of the
    global batch, over torch.distributed. Rendezvous from torchrun's
    environment where it is set, else a file:// store; the backend is nccl
    where every rank has a card of its own, else gloo (which carries CUDA
    tensors too, so several ranks can share one card); a second gloo group
    carries host tensors and objects when the first is nccl. Rank 0 runs the
    loaders and hands every rank its rows (rank_batches), so the global batch
    is the one-process batch bit for bit;
  * dense eval keeps one process and a list of devices (local_devices), as
    the JAX engine keeps one controller over its mesh
    (evaluate/inference.py).

A step over N ranks computes the one-device step on the global batch, up to
the order of sums: the weighted loss mean divides by the all-reduced weight
(losses.py), batch norm takes its statistics over the group with a backward
that all-reduces their gradients (AllReduceSum, models/layers.py), and the
gradients are summed (not averaged) as one flat buffer before the norm, the
clip and the skip (train.py). Every helper takes group=None for one
process and then does nothing at all.
'''

import contextlib
import dataclasses
import os
import tempfile
import time
import uuid

import numpy as np
import torch
import torch.distributed as dist

__all__ = ['Group', 'local_devices', 'resolve_data_parallel',
           'torchrun_env', 'group_backend', 'init_group', 'destroy_group', 'spawn',
           'shard_rows', 'rank_batches', 'all_reduce_sum', 'AllReduceSum', 'all_reduce_flat',
           'broadcast_flat', 'broadcast_object', 'all_true', 'host_sum', 'barrier',
           'rank_seed']

# The end of an epoch and a loader failure, as rank 0 tells the other ranks.
_END = '__o4d_end_of_epoch__'
_FATAL = '__o4d_loader_failed__'


@dataclasses.dataclass
class Group:
    '''One rank's view of its process group: the default group carries
    device tensors, `host` CPU tensors and objects (a gloo group; None: the
    default group, when that is gloo).'''
    rank: int
    size: int
    device: torch.device
    backend: str
    host: object = None

    @property
    def is_main(self):
        return self.rank == 0


def local_devices(n=-1, device='cuda'):
    '''The make_mesh counterpart: the first n devices of a type, -1 (or
    None) for all. On 'cuda' n above the visible cards raises as the JAX
    make_mesh's assert does; on 'cpu' it is n CPU ranks (the JAX tests'
    forced host devices), -1 meaning one.'''
    dev = torch.device(device)
    if dev.type == 'cpu':
        return [torch.device('cpu')] * (1 if n is None or n < 1 else int(n))
    if dev.type != 'cuda':
        raise ValueError(f'device type {dev.type!r}: cuda or cpu')
    avail = torch.cuda.device_count()
    if n is None or n < 0:
        n = avail
    if n > avail:
        raise AssertionError(f'{n} > {avail} available')
    if n == 0:
        raise RuntimeError('CUDA device requested but none is visible; pass device="cpu" '
                           'to run the plain versions')
    return [torch.device('cuda', i) for i in range(n)]


def resolve_data_parallel(data_parallel, batch_size, device='cuda'):
    '''The devices of --data_parallel, as the JAX Trainer resolves it
    (occlusions4d_tpu/train.py:237-252): -1 is the largest divisor of
    batch_size that the host's devices hold. (config.verify_args refuses a
    batch that does not divide over an explicit count; the Trainer of a
    group checks it again where the ranks are known.)'''
    dp = data_parallel
    if dp is None or dp < 0:
        n_dev = torch.cuda.device_count() if torch.device(device).type == 'cuda' else 1
        dp = max(d for d in range(1, min(batch_size, n_dev) + 1) if batch_size % d == 0)
    return local_devices(dp, device)


def torchrun_env():
    '''(rank, world size, local rank) from torchrun's environment, or None.'''
    env = os.environ
    if not all(k in env for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')):
        return None
    return int(env['RANK']), int(env['WORLD_SIZE']), int(env.get('LOCAL_RANK', env['RANK']))


def group_backend(devices):
    '''nccl where every rank has a card of its own, else gloo (CPU ranks,
    or several ranks on one card).'''
    devices = [torch.device(d) for d in devices]
    distinct = len({str(d) for d in devices}) == len(devices)
    return 'nccl' if distinct and all(d.type == 'cuda' for d in devices) else 'gloo'


def init_group(rank, size, device, backend, init_method=None):
    '''Join the process group as `rank` of `size`, on `device`. CUDA is
    left untouched (the group's first user selects the card, Trainer after
    the loaders have forked their workers).
    :param init_method: a rendezvous URL; None reads torchrun's environment
        (env://). :return Group.'''
    dev = torch.device(device)
    dist.init_process_group(backend, init_method=init_method or 'env://', rank=rank,
                            world_size=size)
    host = dist.new_group(backend='gloo') if backend != 'gloo' else None
    return Group(rank, size, dev, backend, host)


def destroy_group():
    if dist.is_initialized():
        dist.destroy_process_group()


def _spawn_entry(rank, fn, devices, init_method, threads, args):
    if torch.device(devices[rank]).type == 'cpu':
        torch.set_num_threads(threads)
    group = init_group(rank, len(devices), devices[rank], group_backend(devices),
                       init_method)
    try:
        fn(group, *args)
    finally:
        destroy_group()


def spawn(fn, devices, args=(), run_dir=None, timeout=None):
    '''Run fn(group, *args) in one spawned process per entry of `devices`
    (e.g. ['cuda:0', 'cuda:1'], or ['cuda:0', 'cuda:0'] for two ranks on one
    card, or ['cpu', 'cpu']), joined through a file:// store under run_dir
    (default: a new temporary directory). CPU ranks share this process's
    threads. A rank that raises fails the call; past `timeout` seconds every
    rank is killed and TimeoutError raised. fn must be importable by name.'''
    import torch.multiprocessing as mp
    devices = [str(torch.device(d)) for d in devices]
    own_dir = run_dir is None
    run_dir = tempfile.mkdtemp(prefix='o4d_dp_') if own_dir else run_dir
    os.makedirs(run_dir, exist_ok=True)
    store = os.path.abspath(os.path.join(run_dir, f'.rendezvous-{uuid.uuid4().hex}'))
    threads = max(torch.get_num_threads() // len(devices), 1)
    ctx = mp.start_processes(_spawn_entry, args=(fn, devices, 'file://' + store, threads,
                                                 tuple(args)),
                             nprocs=len(devices), join=False, start_method='spawn')
    deadline = None if timeout is None else time.time() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.time() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f'{len(devices)} ranks did not finish in {timeout} s')
    finally:
        with contextlib.suppress(OSError):
            os.remove(store)
        if own_dir:
            with contextlib.suppress(OSError):
                os.rmdir(run_dir)


def shard_rows(batch, rank, size):
    '''The shard_batch counterpart: rank's contiguous rows of every array of
    a batch dict (leading axis split in `size` equal parts; 0-d arrays
    whole). A top-level 'meta_data' entry, host bookkeeping, passes through
    untouched.'''
    out = {}
    for k, v in batch.items():
        if k == 'meta_data':
            out[k] = v
            continue
        if not isinstance(v, torch.Tensor):
            v = np.asarray(v)
        if v.ndim == 0:
            out[k] = v
            continue
        if v.shape[0] % size:
            raise ValueError(f'{k}: {v.shape[0]} rows do not divide over {size} ranks')
        n = v.shape[0] // size
        out[k] = v[rank * n:(rank + 1) * n]
    return out


def rank_batches(global_batches, group):
    '''Each rank's rows of a stream of global batches read on rank 0 (the
    other ranks pass None): rank 0 draws a batch and scatters the rows over
    the host group. A batch that does not shard reaches every rank as the
    RuntimeError it raised (the train loop's data-error tolerance); a loader
    failure on rank 0 raises on every rank. Every rank ends with rank 0's
    iterator.'''
    it = iter(global_batches) if group.is_main else None
    while True:
        parts, err = None, None
        if group.is_main:
            try:
                batch = next(it, _END)
            except Exception as e:  # the loader itself failed: end everywhere.
                batch, err = _FATAL, e
            if isinstance(batch, str):
                parts = [(batch, repr(err))] * group.size
            else:
                try:
                    parts = [shard_rows(batch, r, group.size) for r in range(group.size)]
                except Exception as e:
                    parts = [RuntimeError(f'the batch does not shard: {e!r}')] * group.size
        got = [None]
        dist.scatter_object_list(got, parts, src=0, group=group.host)
        item = got[0]
        if isinstance(item, tuple):
            if item[0] == _FATAL:
                if err is not None:
                    raise err
                raise RuntimeError(f'the loader failed on rank 0: {item[1]}')
            return
        yield item


def all_reduce_sum(t, group):
    '''Sum of t over the group (a new tensor; no gradient). t itself
    without a group.'''
    if group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


class AllReduceSum(torch.autograd.Function):
    '''Sum over the group whose backward sums the gradients over the group:
    each rank's term feeds every rank's result, so its gradient is the sum
    of every rank's gradient of the result (the batch-norm statistics'; a
    forward-only sum would leave each rank the gradient of its own loss).'''

    @staticmethod
    def forward(ctx, t):
        out = t.detach().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_flat(tensors, group):
    '''Sum each tensor of a list over the group in one all-reduce of their
    concatenation. :return new tensors (the inputs without a group).'''
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


@torch.no_grad()
def broadcast_flat(tensors, group, src=0):
    '''Copy rank src's values of a list of tensors into every rank's (one
    broadcast of their concatenation).'''
    if group is None or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.broadcast(flat, src=src)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


def broadcast_object(obj, group, src=0):
    '''Rank src's picklable object on every rank (obj itself without a group).'''
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group.host)
    return box[0]


def all_true(flag, group):
    '''Whether a host-side flag holds on every rank (one all-reduce of the
    host group); the flag itself without a group.'''
    if group is None:
        return bool(flag)
    t = torch.tensor([0 if flag else 1], dtype=torch.int32)
    dist.all_reduce(t, group=group.host)
    return int(t) == 0


def host_sum(n, group):
    '''Sum of a host integer over the group (one all-reduce of the host
    group, no device sync); n itself without a group.'''
    if group is None:
        return int(n)
    t = torch.tensor([int(n)], dtype=torch.int64)
    dist.all_reduce(t, group=group.host)
    return int(t)


def barrier(group):
    if group is not None:
        dist.barrier(group=group.host)


def rank_seed(seed, group):
    '''A generator seed of its own for each rank: rank 0's is `seed` (so one
    process draws what it always drew), rank r's seed + r * 2**40.'''
    return int(seed) + (0 if group is None else group.rank << 40)
