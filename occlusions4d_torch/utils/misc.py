'''Host helpers of evaluation (own copy of occlusions4d_tpu/utils/misc.py's
multi_track_merge; numpy only).'''

import numpy as np

__all__ = ['multi_track_merge']


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
