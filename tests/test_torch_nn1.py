'''
The eval engine's ground-truth 1-NN of the port (evaluate/inference.py::nn1,
ops/knn.py::nn1_direct) against the JAX engine's host op
occlusions4d_tpu.native.nn1_host, on the CPU.

Both compute d2 = (dx dx + dy dy) + dz dz per pair and keep the lowest key
index on a tie. nn1_host's object file is compiled without
-ffp-contract=off, so its sums may round through fused multiply-adds: its
bits can differ from the port's by an ulp. Labels (d < radius) and indices
are therefore held equal except at rows that a float64 recomputation shows
to be ambiguous: best and second-best distance within 1e-6 relative, or the
best distance within 1e-6 of the radius (relative). Those rows are counted
and reported; distances agree within rtol 1e-6.

The CARLA-scale cloud is the case the kNN operator's expansion
|k|^2 - 2 q.k + |q|^2 gets wrong: keys 40-80 m from the origin, queries
0.195-0.205 from a key, so labels are read at the radius with d2 ~ 0.04
against |q|^2 ~ 4000.
'''

import importlib

import numpy as np
import pytest
import torch

# Six test workers share eight cores: keep PyTorch's CPU pool small.
torch.set_num_threads(2)

from occlusions4d_tpu.native import nn1_host
from occlusions4d_torch.evaluate import inference as t_inf

t_knn = importlib.import_module('occlusions4d_torch.ops.knn')

RADIUS = 0.2


def ambiguous_rows(query, keys, radius=RADIUS, rel=1e-6):
    '''Rows whose 1-NN or label a last-bit difference may change: best and
    second-best float64 distance within `rel`, or best within `rel` of the
    radius (relative). :return bool (N,).'''
    q = np.asarray(query, np.float64)[:, :3]
    k = np.asarray(keys, np.float64)[:, :3]
    out = np.zeros(len(q), bool)
    rows = max(1, 2 ** 21 // len(k))
    for r0 in range(0, len(q), rows):
        d = np.sqrt(((q[r0:r0 + rows, None, :] - k[None]) ** 2).sum(-1))
        two = np.sort(d, axis=1)[:, :2] if d.shape[1] > 1 else np.c_[d, np.full(len(d), np.inf)]
        tie = two[:, 1] - two[:, 0] <= rel * np.maximum(two[:, 0], 1e-30)
        cross = np.abs(two[:, 0] - radius) <= rel * radius
        out[r0:r0 + rows] = tie | cross
    return out


def carla_scale_cloud(seed=0, n_keys=16384, n_query=2000):
    '''Keys in a 40 x 30 x 4 m box 40-80 m from the origin along x; each
    query 0.195-0.205 from a random key, in a random direction.'''
    rng = np.random.RandomState(seed)
    keys = (rng.rand(n_keys, 3) * [40.0, 30.0, 4.0] + [40.0, -15.0, -1.0]).astype(np.float32)
    src = keys[rng.randint(0, n_keys, n_query)].astype(np.float64)
    direction = rng.randn(n_query, 3)
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    dist = rng.uniform(0.195, 0.205, n_query)
    return (src + direction * dist[:, None]).astype(np.float32), keys


def assert_nn1_matches_host(d, idx, query, keys, radius=RADIUS):
    '''Labels and indices equal to nn1_host's outside the ambiguous rows,
    distances within rtol 1e-6. :return the number of ambiguous rows.'''
    d_ref, i_ref = nn1_host(query[:, :3], keys[:, :3])
    amb = ambiguous_rows(query, keys, radius)
    np.testing.assert_array_equal(idx[~amb], i_ref[~amb])
    np.testing.assert_array_equal((d < radius)[~amb], (d_ref < radius)[~amb])
    np.testing.assert_allclose(d, d_ref, rtol=1e-6, atol=0)
    return int(amb.sum())


def test_eval_nn1_matches_nn1_host_at_carla_scale():
    '''The port's eval 1-NN (device='cpu': the plain version) labels and
    indexes every query as nn1_host does on the CARLA-scale cloud; the
    kNN operator's expansion flips labels there.'''
    query, keys = carla_scale_cloud()
    d, idx = t_inf.nn1(query, keys, 'cpu')
    assert d.dtype == np.float32 and d.shape == idx.shape == (len(query),)
    n_amb = assert_nn1_matches_host(d, idx, query, keys)
    print(f'ambiguous rows: {n_amb} of {len(query)}')
    assert n_amb <= len(query) // 100
    # The cloud does probe the radius: many queries within 5 mm of it.
    assert int((np.abs(d - RADIUS) < 5e-3).sum()) > len(query) // 2


def test_nn1_direct_plain_ties_and_per_pair_arithmetic():
    '''Duplicate keys: the lowest index wins; the distance is the float32
    (dx dx + dy dy) + dz dz of the winner, square-rooted, for every row.'''
    rng = np.random.RandomState(4)
    keys = (rng.rand(300, 3) * 60.0 + 20.0).astype(np.float32)
    keys[200:] = keys[:100]                      # every key 0-99 twice.
    query = np.concatenate([keys[:50] + 0.01, (rng.rand(150, 3) * 60.0 + 20.0)],
                           0).astype(np.float32)
    d, idx = t_knn.nn1_direct(torch.tensor(query), torch.tensor(keys))
    d, idx = d.numpy(), idx.numpy()
    assert idx.dtype == np.int32 and not (idx >= 200).any()
    np.testing.assert_array_equal(idx[:50], np.arange(50))
    diff = keys[idx] - query
    d2 = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) + diff[:, 2] * diff[:, 2]
    np.testing.assert_array_equal(d, np.sqrt(d2.astype(np.float32)))
    assert_nn1_matches_host(d, idx, query, keys)
