'''
The brute-force kNN search of the port (csrc/knn.cu knn_brute_kernel behind
ops/knn.py knn_rank) and the index-route interpolation, on the CPU.

A Python model of the CUDA kernel's split and merge (_emulate_brute_kernel:
lane shares, each lane's smallest values, the group's bound tau, the
rejections, the slots and their overflow, the rank merge) must equal the
plain version knn_rank_plain bit for bit, distances and indices; the
port's knn_extract must equal JAX's on the cv1 route's search (more than
1024 keys, grid-ordered queries); the port's interpolation must match JAX's
fused_knn_interp at a feature width that is not a multiple of 4 (the
kernel's scalar path), in f32 and bf16. Inputs are made with numpy from a
seed and handed to both packages. Tolerances: kNN exact; the interpolation
atol 3e-5 / rtol 1e-4 in f32 (other summation orders) and rtol 1e-5 /
atol 1e-6 in bf16 (test_torch_fast.py's gate: exact bf16 products).
'''

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# Six test workers share eight cores: keep PyTorch's CPU pool small.
torch.set_num_threads(2)

from occlusions4d_tpu.ops import pallas_attention as j_pa

t_knn = importlib.import_module('occlusions4d_torch.ops.knn')
t_attn = importlib.import_module('occlusions4d_torch.ops.attention')
t_sampling = importlib.import_module('occlusions4d_torch.ops.sampling')
t_bounds = importlib.import_module('occlusions4d_torch.ops.bounds')

_FLT_MAX = np.float32(3.4028234663852886e38)
_INT_MAX = 2 ** 31 - 1


@pytest.fixture
def rng():
    return np.random.RandomState(61)


def _t(a):
    return torch.tensor(np.asarray(a))


def _rank_values(q, kk, kn):
    '''d = |k|^2 - 2 ((q0 k0 + q1 k1) + q2 k2), each operation rounded in
    f32 (the kernel's rank_value): (B, N, M).'''
    dot = (q[:, :, None, 0] * kk[:, None, :, 0] + q[:, :, None, 1] * kk[:, None, :, 1]) \
        + q[:, :, None, 2] * kk[:, None, :, 2]
    return kn[:, None, :] - 2.0 * dot


def _select(d, i, n, r):
    '''The (d, index) of rank r among the first n slots (d, i): the rank of
    each is the count of slots before it in (d, index) order.'''
    for e in range(n):
        rank = sum(1 for m in range(n) if d[m] < d[e] or (d[m] == d[e] and i[m] < i[e]))
        if rank == r:
            return d[e], i[e]
    raise AssertionError('no slot of that rank')


def _emulate_brute_kernel(q, kk, kn, k, lanes, capL=8):
    '''Python model of csrc/knn.cu::knn_brute_kernel: `lanes` lanes per
    query, lane g scanning keys c = g mod lanes; a first scan keeps each
    lane's S smallest ranking values (S the power of two with lanes * S >=
    2k); tau, the k-th smallest of the group's lanes * S values (with
    multiplicity), an infinite tau made FLT_MAX; a second scan keeps each
    lane's keys at or below tau in its capL (kBruteSlots) registers. If a
    lane had more, the
    group scans again: keys at (d, index) <= (tau, INT_MAX) into the query's
    lanes * capL slots in key order (the kernel's lane order within a round,
    rounds in key order), counting all that pass; while more pass than the
    slots hold, (tau, index) becomes the (d, index) k-th of the slots and the
    scan runs again. Each held slot's (d, index) rank among all held places
    it; filler rows (+inf, 0) past their count.
    :return (d (B, N, k), idx (B, N, k) int32, the most keys a query held,
        the most scans after the first a query took).'''
    S = 1
    while lanes * S < 2 * k:
        S *= 2
    cap = lanes * capL
    d_all = _rank_values(q, kk, kn).numpy()
    B, N, M = d_all.shape
    out_d = np.empty((B, N, k), np.float32)
    out_i = np.empty((B, N, k), np.int32)
    most, scans = 0, 0
    idx = np.arange(M)
    for b in range(B):
        for n in range(N):
            d = d_all[b, n]
            vals = np.concatenate([np.concatenate([np.sort(d[g::lanes]),
                                                   np.full(S, np.inf, np.float32)])[:S]
                                   for g in range(lanes)])
            td = np.sort(vals)[k - 1]
            td = td if np.isfinite(td) else _FLT_MAX
            held = idx[d <= td]
            rounds = 1
            if np.bincount(held % lanes, minlength=lanes).max() > capL:
                ti = _INT_MAX
                while True:
                    rounds += 1
                    passing = idx[(d < td) | ((d == td) & (idx <= ti))]
                    held = passing[:cap]
                    if passing.size <= cap:
                        break
                    td, ti = _select(d[held], held, cap, k - 1)
            C = held.size
            most, scans = max(most, C), max(scans, rounds - 1)
            out_d[b, n], out_i[b, n] = np.inf, 0
            for e in range(C):
                rank = sum(1 for m in range(C)
                           if d[held[m]] < d[held[e]] or (d[held[m]] == d[held[e]]
                                                          and held[m] < held[e]))
                if rank < k:
                    out_d[b, n, rank], out_i[b, n, rank] = d[held[e]], held[e]
    return torch.from_numpy(out_d), torch.from_numpy(out_i), most, scans


def _brute_case(rng, case):
    '''(queries (B, N, 3), keys (B, M, 3), key mask or None, K) of a case.'''
    if case == 'grid_ties':        # integer coordinates: exact ties, duplicates.
        k = rng.randint(0, 4, size=(3, 300, 3)).astype(np.float32)
        k[:, 200:260] = k[:, 10:70]
        q = rng.randint(0, 4, size=(3, 7, 3)).astype(np.float32)
        return q, k, None, 14
    if case == 'few_valid':        # 9 valid keys of 200 for K 14: filler rows.
        k = rng.rand(3, 200, 3).astype(np.float32) * 4 - 2
        mask = np.zeros((3, 200), bool)
        for b in range(3):
            mask[b, rng.choice(200, 9, replace=False)] = True
        return rng.rand(3, 5, 3).astype(np.float32) * 4 - 2, k, mask, 14
    if case == 'masked_lane':      # 16 valid keys, all in lane 0's share.
        k = rng.rand(1, 512, 3).astype(np.float32) * 4 - 2
        mask = np.zeros((1, 512), bool)
        mask[0, ::32] = True
        return rng.rand(1, 6, 3).astype(np.float32) * 4 - 2, k, mask, 14
    K = {'k1': 1, 'k14': 14, 'k32': 32}[case.split('_')[0]]
    M = 4133 if case.endswith('wide') else 531
    k = rng.rand(3, M, 3).astype(np.float32) * 10 - 5
    mask = rng.rand(3, M) > 0.2
    return rng.rand(3, 4, 3).astype(np.float32) * 10 - 5, k, mask, K


@pytest.mark.parametrize('lanes', [16, 32])
@pytest.mark.parametrize('case', ['grid_ties', 'few_valid', 'masked_lane', 'k1_uniform',
                                  'k14_uniform', 'k32_uniform', 'k14_wide'])
def test_emulated_brute_kernel_equals_plain(rng, case, lanes):
    '''The model of the brute kernel equals knn_rank_plain bit for bit at
    every lane count: integer-grid ties and duplicate keys, masked keys
    (filler rows when fewer than K are valid; valid keys in one lane's share
    only, which leaves tau infinite and overflows the slots), K 1, 14 and 32, M off the stage size (4133 keys: the kernel
    streams 4096-key tiles), 4 to 7 queries at B 3 (1 for the mask that
    starves the other lanes).'''
    q, k, mask, K = _brute_case(rng, case)
    qq, kk, kn, _ = t_knn._prepare(_t(q), _t(k), None if mask is None else _t(mask))
    d, i, _, _ = _emulate_brute_kernel(qq, kk, kn, K, lanes)
    pd, pi = t_knn.knn_rank_plain(qq, kk, kn, K)
    np.testing.assert_array_equal(i.numpy(), pi.numpy())
    np.testing.assert_array_equal(d.numpy(), pd.numpy())


def test_emulated_brute_kernel_overflow_rescans(rng):
    '''More passing keys than slots: with 300 of 400 keys at one point (one
    ranking value, the nearest) and one slot a lane (16 a query), the group
    scans again with votes, tau moves to the K-th slot and the scan runs
    again until the slots hold every passing key; the result stays exact.'''
    k = rng.rand(1, 400, 3).astype(np.float32)
    k[0, 50:350] = k[0, 3]
    q = (k[0, 3] + rng.rand(1, 3, 3) * 0.01).astype(np.float32)
    qq, kk, kn, _ = t_knn._prepare(_t(q), _t(k), None)
    d, i, most, scans = _emulate_brute_kernel(qq, kk, kn, 5, 16, capL=1)
    pd, pi = t_knn.knn_rank_plain(qq, kk, kn, 5)
    np.testing.assert_array_equal(i.numpy(), pi.numpy())
    np.testing.assert_array_equal(d.numpy(), pd.numpy())
    assert scans >= 2 and most <= 16


@pytest.mark.parametrize('K', [12, 14, 16])
def test_brute_bound_passes_few_keys(rng, K):
    '''On a uniform cloud the bound lets few keys past the first scan: at
    the encoder's and the decoder's K, with the lane counts the rule picks
    for them, at most 2K keys of a query reach the slots and no lane
    overflows its own slots (no vote scan).'''
    k = rng.rand(1, 531, 3).astype(np.float32) * 10 - 5
    q = rng.rand(1, 24, 3).astype(np.float32) * 10 - 5
    qq, kk, kn, _ = t_knn._prepare(_t(q), _t(k), None)
    for lanes in (16, 32):
        _, _, most, scans = _emulate_brute_kernel(qq, kk, kn, K, lanes)
        assert most <= 2 * K and scans == 0, (lanes, most, scans)


@pytest.mark.parametrize('BN, want', [(531, 32), (3 * 531, 32), (4779, 32), (16895, 32),
                                      (16896, 16), (32768, 16), (3 * 17203, 16)])
def test_brute_lanes_rule(BN, want):
    '''Lanes per query from B * N: a warp per query below two waves of 1024
    threads per SM at 16 lanes (the encoder's searches), 16 lanes above
    (the decoder's chunks and train frames).'''
    assert t_knn.brute_lanes(1, BN) == want


def test_knn_extract_matches_jax_on_the_cv1_search(rng):
    '''The decoder's search on the cv1 route: K 14 over 1100 keys (more than
    1024, some masked), grid-ordered queries (a slab of grid_points_numpy's
    order, many equidistant from their neighbours' keys); indices exact,
    squared distances at test_torch_ops.py's f32 tolerance.'''
    cube = t_bounds.Cuboid(-1.0, 1.0, -1.0, 1.0, -1.0, 1.0)
    q = t_sampling.grid_points_numpy(4096, cube)[1000:1256][None].astype(np.float32)
    k = rng.rand(1, 1100, 3).astype(np.float32) * 2 - 1
    mask = rng.rand(1, 1100) > 0.1
    ji, jd = j_pa.knn_extract(jnp.asarray(q), jnp.asarray(k), 14, key_mask=jnp.asarray(mask))
    ti, tdd = t_attn.knn_extract(_t(q), _t(k), 14, key_mask=_t(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji)[:, :256, :14])
    np.testing.assert_allclose(tdd.numpy(), np.asarray(jd)[:, :256, :14], atol=3e-5, rtol=1e-4)
    # The plain search under it is the model's at the rule's lanes.
    qq, kk, kn, _ = t_knn._prepare(_t(q), _t(k), _t(mask))
    d, i, _, _ = _emulate_brute_kernel(qq, kk, kn, 14, t_knn.brute_lanes(1, 256))
    np.testing.assert_array_equal(i.numpy(), ti.numpy())


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_interp_matches_jax_at_odd_width(rng, dtype):
    '''The index-route interpolation at E 37 (not a multiple of 4: the
    kernel's scalar path) against JAX's fused_knn_interp, f32 and bf16, and
    the plain version against the operator.'''
    B, N, M, E, K_EXT, K = 2, 90, 70, 37, 14, 8
    q = rng.rand(B, N, 3).astype(np.float32) * 2 - 1
    pos2 = rng.rand(B, M, 3).astype(np.float32) * 2 - 1
    feats = rng.randn(B, M, E).astype(np.float32)
    mask = rng.rand(B, M) > 0.2
    jcd, tcd = ((jnp.float32, torch.float32) if dtype == 'f32'
                else (jnp.bfloat16, torch.bfloat16))
    jknn = j_pa.knn_extract(jnp.asarray(q), jnp.asarray(pos2), K_EXT,
                            key_mask=jnp.asarray(mask))
    ref = np.asarray(j_pa.fused_knn_interp(jnp.asarray(q), jnp.asarray(pos2),
                                           jnp.asarray(feats), K, key_mask=jnp.asarray(mask),
                                           knn=jknn, compute_dtype=jcd))
    tknn = t_attn.knn_extract(_t(q), _t(pos2), K_EXT, key_mask=_t(mask))
    out = t_attn.fused_knn_interp(_t(q), _t(pos2), _t(feats), K, knn=tknn,
                                  compute_dtype=tcd).numpy()
    tol = dict(atol=3e-5, rtol=1e-4) if dtype == 'f32' else dict(atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(out, ref, **tol)
    plain = t_attn.interp_plain(tknn[0], tknn[1], _t(feats), K, 1e-4, tcd).numpy()
    np.testing.assert_array_equal(out, plain)
