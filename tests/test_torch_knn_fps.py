'''
The FPS kernel's reduction (csrc/fps.cu) modelled in plain PyTorch on the
CPU: its packed-key argmax (ops/fps.py packed_argmax_plain) against
torch.argmax, and the whole pick sequence of a model of the kernel (points
split over the blocks of a cluster and the threads of a block, each
thread's first largest field, the packed-key max over the candidates)
against the JAX package's fps_batched (XLA path) and fps_pallas_batched
(interpret mode), as tests/test_torch_ops.py::test_fps_matches_jax runs
them. Inputs are made with numpy from a seed and handed to both.

Tolerances: exact (indices).
'''

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# Six test workers share eight cores: keep PyTorch's CPU pool small.
torch.set_num_threads(2)

from occlusions4d_tpu.ops.fps import fps_batched as j_fps_batched
from occlusions4d_tpu.ops.pallas_fps import fps_pallas_batched as j_fps_pallas

t_fps = importlib.import_module('occlusions4d_torch.ops.fps')


def _t(a):
    return torch.tensor(np.asarray(a))


def _scores(case):
    rng = np.random.RandomState(7)
    s = rng.rand(4, 97).astype(np.float32)
    if case == 'neg_inf_penalties':
        s[rng.rand(4, 97) > 0.5] = -np.inf
        s[2] = -np.inf                                   # every point invalid.
    elif case == 'equal_scores':
        s = rng.randint(0, 3, size=(4, 97)).astype(np.float32)
    elif case == 'denormals':
        tiny = np.float32(1e-45)
        s = (rng.randint(0, 4, size=(4, 97)) * tiny).astype(np.float32)
        s[1, 50:] = np.float32(1.1754942e-38)           # the largest denormal.
    elif case == 'zeros_and_huge':
        s[:, ::3] = 0.0
        s[0, [5, 9]] = np.float32(3.4e38)
        s[3] = np.inf
    return _t(s)


@pytest.mark.parametrize('case', ['random', 'neg_inf_penalties', 'equal_scores',
                                  'denormals', 'zeros_and_huge'])
def test_packed_argmax_is_the_first_index_of_the_max(case):
    '''The kernel's key (order-preserving score bits, complemented index)
    picks what torch.argmax picks: the first index of the largest score,
    with -inf rows, ties, denormals and +inf.'''
    s = _scores(case)
    np.testing.assert_array_equal(t_fps.packed_argmax_plain(s).numpy(),
                                  torch.argmax(s, dim=-1).numpy())
    # Over candidates given with their point indices, in any order.
    perm = torch.randperm(s.shape[-1], generator=torch.Generator().manual_seed(1))
    got = t_fps.packed_argmax_plain(s[:, perm], perm.expand(s.shape))
    np.testing.assert_array_equal(got.numpy(), torch.argmax(s, dim=-1).numpy())


def _fps_kernel_model(xyz, n_out, valid, start, C, T):
    '''Python model of csrc/fps.cu's picks: fields start at +inf (valid) or
    -inf (invalid); per pick the fields take the distance to the last pick,
    block r of the cluster owns points [r S, (r + 1) S) (S = ceil(N / C)),
    point i of a slice sits on thread i mod T, each thread offers its first
    largest field, and packed_argmax_plain picks among the offers.'''
    B, N, _ = xyz.shape
    S = -(-N // C)
    ppt = -(-S // T)
    field = torch.where(valid, torch.tensor(float('inf')), torch.tensor(float('-inf')))
    x, y, z = xyz.unbind(-1)
    last = start.long()
    sel = [last]
    t = torch.arange(T)
    for _ in range(1, n_out):
        dx = x - x.gather(1, last[:, None])
        dy = y - y.gather(1, last[:, None])
        dz = z - z.gather(1, last[:, None])
        field = torch.minimum(field, (dx * dx + dy * dy) + dz * dz)
        scores, index = [], []
        for r in range(C):
            n_loc = min(N, (r + 1) * S) - r * S
            if n_loc <= 0:
                continue
            f = torch.full((B, ppt * T), float('-inf'))
            f[:, :n_loc] = field[:, r * S:r * S + n_loc]
            q = torch.argmax(f.view(B, ppt, T), dim=1)      # a thread's first max.
            live = t < n_loc
            scores.append(f.view(B, ppt, T).gather(1, q[:, None])[:, 0][:, live])
            index.append((r * S + t + q * T)[:, live])
        last = t_fps.packed_argmax_plain(torch.cat(scores, 1), torch.cat(index, 1))
        sel.append(last)
    return torch.stack(sel, 1)


@pytest.mark.parametrize('case', ['plain', 'mask_start', 'n_out_one', 'ragged',
                                  'duplicates'])
def test_fps_kernel_model_matches_jax(case):
    '''The kernel's pick sequence, modelled for one block of 64 threads, a
    cluster of 3 blocks of 32 threads and one of 4 blocks of 64 threads (N
    not a multiple of any), equals the JAX XLA loop and the Pallas kernel
    pick for pick (sorted, as fps_batched returns them) and in pick order
    the port's plain loop.'''
    rng = np.random.RandomState(29)
    B, N, n_out = 2, 300, 64
    valid, start = np.ones((B, N), bool), np.zeros(B, np.int64)
    xyz = rng.rand(B, N, 3).astype(np.float32)
    if case == 'mask_start':
        valid = rng.rand(B, N) > 0.4
        start = np.array([np.flatnonzero(valid[b])[0] for b in range(B)])
    elif case == 'n_out_one':
        n_out, start = 1, np.array([9, 4])
    elif case == 'ragged':
        B, N, n_out = 1, 391, 137
        xyz = rng.rand(B, N, 3).astype(np.float32)
        valid, start = np.ones((B, N), bool), np.zeros(B, np.int64)
    elif case == 'duplicates':
        xyz = rng.randint(0, 4, size=(B, N, 3)).astype(np.float32)
        n_out = 40
    jkw = dict(valid=jnp.asarray(valid), start_idx=jnp.asarray(start.astype(np.int32)))
    ref = np.asarray(j_fps_batched(jnp.asarray(xyz), n_out, use_pallas=False, **jkw))
    ref_pallas = np.asarray(j_fps_pallas(jnp.asarray(xyz), n_out, **jkw))
    plain = t_fps.fps_plain(_t(xyz), n_out, _t(valid), _t(start))
    for C, T in ((1, 64), (3, 32), (4, 64)):
        sel = _fps_kernel_model(_t(xyz), n_out, _t(valid), _t(start), C, T)
        np.testing.assert_array_equal(sel.numpy(), plain.numpy())
        srt = torch.sort(sel, dim=-1).values.numpy()
        np.testing.assert_array_equal(srt, ref)
        np.testing.assert_array_equal(srt, ref_pallas)
