'''Host helpers of the data plane and evaluation (own copy of
occlusions4d_tpu/utils/misc.py; numpy only): point-cloud video assembly,
biased shuffles, dataset-kind inference and multi-track prediction merging.'''

import numpy as np

__all__ = ['accumulate_pcl_time', 'merge_pcl_views', 'elitist_shuffle',
           'multi_track_merge', 'get_data_kind', 'find_mask_ranges']


def accumulate_pcl_time(pcl):
    '''
    Point-cloud snapshots -> video with a trailing time feature in {0..T-1}
   .
    :param pcl: (V, T, N, D) numpy array, or list-V of list-T of (N_t, D)
        numpy arrays (N may vary per frame).
    :return (V, T*N, D+1) array, or list-V of (sum_T N_t, D+1) numpy arrays.
    '''
    if isinstance(pcl, np.ndarray):
        (V, T, N, D) = pcl.shape
        tv = np.broadcast_to(np.arange(T, dtype=pcl.dtype)[None, :, None, None],
                             (V, T, N, 1))
        return np.concatenate([pcl, tv], axis=-1).reshape(V, T * N, D + 1)
    out = []
    for view in pcl:
        # Single preallocated fill (the concatenate chain copies every frame
        # twice; at heavy scale this view buffer is ~25 MB).
        total = sum(f.shape[0] for f in view)
        buf = np.empty((total, view[0].shape[1] + 1), view[0].dtype)
        o = 0
        for t, frame in enumerate(view):
            n = frame.shape[0]
            buf[o:o + n, :-1] = frame
            buf[o:o + n, -1] = float(t)
            o += n
        out.append(buf)
    return out


def merge_pcl_views(pcl, insert_view_idx=False):
    '''
    Per-frame multi-view merge; optionally inserts the view index between the
    semantic columns and the trailing RGB triple.
    :param pcl: (V, T, N, D) numpy array, or list-V of list-T of (N, D)
        numpy arrays.
    :return (T, V*N, D) array, or list-T of (sum_V N_v, D[+1]) numpy arrays.
    '''
    if isinstance(pcl, np.ndarray):
        assert not insert_view_idx
        (V, T, N, D) = pcl.shape
        return pcl.transpose(1, 0, 2, 3).reshape(T, V * N, D)
    V, T = len(pcl), len(pcl[0])
    out = []
    for t in range(T):
        if not insert_view_idx:
            out.append(np.concatenate([pcl[v][t] for v in range(V)], axis=0))
            continue
        total = sum(pcl[v][t].shape[0] for v in range(V))
        D = pcl[0][t].shape[1]
        buf = np.empty((total, D + 1), pcl[0][t].dtype)
        o = 0
        for v in range(V):
            frame = pcl[v][t]
            n = frame.shape[0]
            buf[o:o + n, :D - 3] = frame[:, :-3]
            buf[o:o + n, D - 3] = float(v)
            buf[o:o + n, D - 2:] = frame[:, -3:]
            o += n
        out.append(buf)
    return out


def elitist_shuffle(items, inequality, rng=None):
    '''
    Rank-biased shuffle: higher-ranked items tend to stay high.
    '''
    rng = np.random if rng is None else rng
    weights = np.power(np.linspace(1, 0, num=len(items), endpoint=False), inequality)
    weights = weights / np.linalg.norm(weights, ord=1)
    return rng.choice(items, size=len(items), replace=False, p=weights)


def get_data_kind(dset_root):
    '''Dataset-kind inference from the path.'''
    low = dset_root.lower()
    if 'gr_' in low or 'greater' in low:
        return 'greater'
    if 'carla' in low:
        return 'carla'
    raise ValueError(dset_root)


def find_mask_ranges(mask):
    '''
    First [start, end) run of True per row.
    :param mask (B, N) bool numpy array.
    :return (B, 2) int array.
    '''
    mask = np.asarray(mask, np.int32)
    delta = mask[..., 1:] - mask[..., :-1]
    delta = np.concatenate([np.full_like(delta[..., :1], 0.5, dtype=np.float32),
                            delta.astype(np.float32),
                            np.full_like(delta[..., :1], -0.5, dtype=np.float32)],
                           axis=-1)
    return np.stack([delta.argmax(axis=-1), delta.argmin(axis=-1)], axis=-1)


def multi_track_merge(track_instance_ids, pcl_abstract, features_global,
                      implicit_output, output_track_idx):
    '''
    Merge per-instance inference reruns: average all features, then overwrite
    the mark_track column with the instance id of the highest-confidence
    (>= 0.5) detection per point, -1 when nothing is confident.
    '''
    assert len(pcl_abstract) == len(features_global) == len(implicit_output)
    num_tracks = len(pcl_abstract)

    if num_tracks >= 3 and pcl_abstract[0] is not None:
        # Deterministic FPS must give identical abstract coords across reruns.
        np.testing.assert_array_almost_equal(pcl_abstract[0][..., :3],
                                             pcl_abstract[1][..., :3])
        np.testing.assert_array_almost_equal(pcl_abstract[0][..., :3],
                                             pcl_abstract[-1][..., :3])

    if num_tracks == 1 and track_instance_ids[0] == -1:
        return (pcl_abstract[0], features_global[0], implicit_output[0])

    merged_abstract = (np.mean(pcl_abstract, axis=0)
                       if pcl_abstract[0] is not None else None)
    merged_global = np.mean(features_global, axis=0)
    merged_output = np.mean(implicit_output, axis=0)

    mark = -np.ones_like(merged_output[..., 0])
    confidence = np.zeros_like(merged_output[..., 0])
    for track_i in range(num_tracks):
        score = implicit_output[track_i][..., output_track_idx]
        detect = np.logical_and(score >= 0.5, score >= confidence)
        mark[detect] = track_instance_ids[track_i]
        confidence = np.maximum(score, confidence)
    merged_output[..., output_track_idx] = mark

    return (merged_abstract, merged_global, merged_output)
