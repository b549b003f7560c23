'''
Shared data-plane machinery (own copy of occlusions4d_tpu/data/common.py):
VALO (visible-at-least-once) instance analysis, occlusion-biased clip
selection with a counter board the loader's workers share, and
fixed-capacity padding helpers:
  * get_valo_ids;
  * the clip counter + elitist shuffle clip selection;
  * subsample_pad: zero-pad when short, random or farthest-point subsample
    when long, with a true-size record.

Per-example randomness is numpy, seeded exactly as in the JAX package
(example_rng): the same (seed, epoch, index) gives the same example in both.
'''

import threading

import numpy as np

from ..native import fps_host
from ..utils.misc import elitist_shuffle

__all__ = ['CounterBoard', 'get_valo_ids', 'subsample_pad', 'pad_rows',
           'pick_biased_frame_start', 'example_rng']


def example_rng(seed, epoch, index):
    '''Per-example generator derived from (seed, epoch, index).

    Replaces the single dataset-wide RandomState that loader threads would race on
    (RandomState is not thread-safe) and makes num_workers > 1 bit-reproducible:
    the same (seed, epoch, index) always yields the same example, regardless of
    worker count or scheduling.
    '''
    root = np.random.SeedSequence((int(seed) & 0xffffffff, int(epoch), int(index)))
    return np.random.RandomState(root.generate_state(1)[0])


class CounterBoard:
    '''Per-(scene, frame) usage counters shared by the loader's workers.

    Default (shared=False): an array behind an RLock, for the loader's
    worker threads. shared=True backs the counters with a
    multiprocessing.Array (and its lock), so that the fork worker processes
    of Loader(worker_mode='process') see one board.'''

    def __init__(self, num_scenes, max_frames=10101, shared=False):
        self.max_frames = max_frames
        if shared:
            import multiprocessing
            self._mp_arr = multiprocessing.Array('i', int(num_scenes * max_frames))
            self.counts = np.frombuffer(
                self._mp_arr.get_obj(), np.int32).reshape(num_scenes, max_frames)
            self.lock = self._mp_arr.get_lock()
        else:
            self.counts = np.zeros((num_scenes, max_frames), np.int32)
            self.lock = threading.RLock()

    def try_claim(self, scene_idx, frame_start, ignore_taken_prob=0.0, rng=None):
        '''Claim a clip if free. With probability ignore_taken_prob the taken-check is
        skipped (CARLA allows occasional double counting during train).'''
        with self.lock:
            check = True
            if ignore_taken_prob > 0.0 and rng is not None:
                check = rng.rand() < (1.0 - ignore_taken_prob)
            if check and self.counts[scene_idx, frame_start] > 0:
                return False
            self.counts[scene_idx, frame_start] += 1
            return True


def pick_biased_frame_start(occl_curve, frame_low, frame_start_high, time_shift,
                            select_top, counter, scene_idx, stage, rng,
                            counter_double_prob=0.0):
    '''
    Occlusion-biased clip selection: rank frames by occlusion rate, elitist-shuffle
    during train, walk the ranking skipping out-of-range / already-used clips
   .
    :return (frame_start or None, occl_frame_idx, found_occl_rate).
    '''
    select_top = min(select_top, len(occl_curve))
    top = np.argpartition(occl_curve, -select_top)[-select_top:]
    top = top[np.argsort(occl_curve[top])][::-1]
    if 'test' not in stage:
        top = elitist_shuffle(top, inequality=4, rng=rng)
    for occl_frame_idx in top:
        try_start = int(occl_frame_idx) - time_shift
        if try_start < frame_low or frame_start_high <= try_start:
            continue
        if counter is not None:
            prob = 0.0 if 'test' in stage else counter_double_prob
            if not counter.try_claim(scene_idx, try_start,
                                     ignore_taken_prob=prob, rng=rng):
                continue
        return try_start, int(occl_frame_idx), float(occl_curve[occl_frame_idx])
    return None, -1, -1.0


def shuffle_rows(a, rng):
    '''Row shuffle of an (N, D) array via permutation + gather. Semantically a
    plain random shuffle (like np.random.shuffle on the cloud), but ~15x
    faster: RandomState.shuffle on a
    multidimensional array falls back to a per-swap buffer-copy loop (~1.1 s
    for 786k x 8 f32; permutation + fancy gather is ~70 ms). Draws a different
    RandomState sequence than in-place shuffle, which is fine — the stream is
    only pinned per (seed, epoch, index), not to a specific op sequence.'''
    return a[rng.permutation(a.shape[0])]


def subsample_pad(pcl, n_desired, mode='random', rng=None, retain_vehped=False,
                  segm_idx=None, fps_start=0, shuffle=False):
    '''
    Fixed-capacity resize of an (N, D) cloud:
      * N < n_desired: zero-pad (true size returned);
      * N > n_desired: 'random' subsample (sorted indices) or 'farthest_point' FPS;
        retain_vehped keeps all semantic-tag 4/10 rows.
    shuffle=True is bit-identical to shuffle_rows(pcl, rng) followed by this
    function (same rng stream: permutation first), but composes the permutation
    with the subsample gather so 'random' mode only materializes the kept rows
    (a ~200k-row frame gathers 28k rows instead of all of them).
    :return (out (n_desired, D), true_size int).
    '''
    rng = np.random if rng is None else rng
    (N, D) = pcl.shape
    perm = rng.permutation(N) if shuffle else None

    def take(idx):  # rows of the (virtually) shuffled cloud.
        return pcl[perm[idx]] if perm is not None else pcl[idx]

    if N < n_desired:
        out = np.zeros((n_desired, D), pcl.dtype)
        out[:N] = pcl if perm is None else pcl[perm]
        return out, N
    if N == n_desired:
        return (pcl if perm is None else pcl[perm]), N

    n_remain = n_desired
    retain = None
    pool = np.arange(N)
    if retain_vehped:
        assert segm_idx is not None
        seg = pcl[:, segm_idx] if perm is None else pcl[perm, segm_idx]
        retain_mask = np.logical_or(seg == 4, seg == 10)
        retain = np.where(retain_mask)[0]
        pool = np.where(seg != 10)[0]
        n_remain -= retain.shape[0]

    if mode == 'random':
        # choice(pool, n, replace=False) draws permutation(len(pool)) from the
        # stream regardless of pool contents, so the shuffled-space selection
        # consumes exactly what the pre-shuffled call consumed.
        inds = rng.choice(pool, min(max(n_remain, 0), pool.shape[0]), replace=False)
        inds.sort()
    elif mode == 'farthest_point':
        assert not retain_vehped
        if perm is not None:
            pcl = pcl[perm]  # FPS consumes every row: materialize once.
            perm = None
        inds = fps_host(pcl[:, :3], n_remain, start_idx=fps_start)
    else:
        raise ValueError(mode)

    out = take(inds)
    if retain is not None:
        out = np.concatenate([take(retain), out], axis=0)[:n_desired]
        if out.shape[0] < n_desired:  # extreme vehped overflow guard.
            pad = np.zeros((n_desired - out.shape[0], D), pcl.dtype)
            out = np.concatenate([out, pad], axis=0)
    return out, n_desired


def pad_rows(pcl, capacity):
    '''Zero-pad (N, D) -> (capacity, D) with a validity count.'''
    (N, D) = pcl.shape
    if N >= capacity:
        return pcl[:capacity], capacity
    out = np.zeros((capacity, D), pcl.dtype)
    out[:N] = pcl
    return out, N


def get_valo_ids(used_input_sem, used_merged_frames, all_pcl, src_view, num_views,
                 pcl_input_frames, video_length, filter_vehped, sem_inst_col,
                 sem_cat_col, merged_inst_col, max_valo_ids, valo_min_points=8,
                 pcl_inst_col=None):
    '''
    VALO ids + live per-instance occlusion fractions, numpy.
    :param used_input_sem (N, 1-3): semantic columns of the (subsampled) input.
    :param used_merged_frames: list-T of (V*N, D) merged frames (only column
        merged_inst_col is read, so callers may pass instance-only columns).
    :param all_pcl: list-V of list-T of per-frame clouds; instance ids read
        from pcl_inst_col (defaults to merged_inst_col).
    :return (live_occl (pcl_input_frames, max_valo_ids), valo_ids_pad (max,),
             num_valo_ids).
    '''
    if pcl_inst_col is None:
        pcl_inst_col = merged_inst_col
    if filter_vehped:
        vehped_mask = np.logical_or(used_input_sem[:, sem_cat_col] == 4,
                                    used_input_sem[:, sem_cat_col] == 10)
        vehped_sem = used_input_sem[vehped_mask]
    else:
        vehped_sem = used_input_sem

    ids = np.unique(used_input_sem[:, sem_inst_col].astype(np.int32))
    # Count per candidate id in one pass (the per-id == scans were ~0.5 s at
    # CARLA scale: ids x frames x 360k-row comparisons).
    cand = ids[ids >= 0].astype(np.int64)
    vcounts = _counts_for(cand, vehped_sem[:, sem_inst_col])
    valo_ids = cand[vcounts >= valo_min_points].tolist()
    num_valo = len(valo_ids)

    live_occl = np.zeros((pcl_input_frames, max_valo_ids), np.float32)
    va = np.asarray(valo_ids[:max_valo_ids], np.int64)
    if va.size:
        merged_cnt = np.stack(
            [_counts_for(va, used_merged_frames[t][:, merged_inst_col])
             for t in range(video_length)])                 # (T, n) int64.
        max_merged = merged_cnt.max(axis=0)                 # (n,) int64.
        for t in range(pcl_input_frames):
            cnt = _counts_for(va, all_pcl[src_view][t][:, pcl_inst_col])
            # f64 math then f32 store: same rounding as the scalar loop.
            live_occl[t, :va.size] = np.maximum(
                1.0 - cnt * num_views / (max_merged + 1e-6), 0.0)

    valo_pad = -np.ones(max_valo_ids, np.int32)
    valo_pad[:num_valo] = valo_ids[:max_valo_ids]
    return live_occl, valo_pad, num_valo


def _counts_for(sorted_ids, values):
    '''Occurrence count of each of `sorted_ids` (ascending int64) in `values`
    (float or int array), via one searchsorted + bincount pass.'''
    if sorted_ids.size == 0:
        return np.zeros(0, np.int64)
    v = np.asarray(values).astype(np.int64)
    hi = int(sorted_ids[-1])
    if int(sorted_ids[0]) >= 0 and hi < 65536:
        # Dense ids: direct histogram (out-of-range rows -> overflow bucket).
        safe = np.where((v >= 0) & (v <= hi), v, hi + 1)
        return np.bincount(safe, minlength=hi + 2)[sorted_ids]
    pos = np.searchsorted(sorted_ids, v)
    pos_c = np.minimum(pos, sorted_ids.size - 1)
    ok = sorted_ids[pos_c] == v
    return np.bincount(pos_c[ok], minlength=sorted_ids.size)
