'''
Metric computation over eval frames and exported test results (own copy of
occlusions4d_tpu/evaluate/metrics.py): it scores the driver's frames as they
come (test_driver --save_metrics) and the pcl_io_s{step}.p artifacts
afterwards. The 1-NN searches run on the host (native.nn1_host), as in the
JAX package, unless the driver hands in its ground-truth 1-NN (nn_solid /
nn_air_d, computed on the card by ops.knn.nn1_direct with the same per-pair
arithmetic).

Metrics per predicted frame:
  * occupancy: precision / recall / F1 / IoU of the density-thresholded solid set
    against ground-truth occupancy (query within point_occupancy_radius of any
    target point - the same criterion as the sampler's air rejection);
  * chamfer: symmetric mean nearest-neighbor distance between the predicted solid
    cloud and the target cloud;
  * color_mae: mean absolute RGB error on true-positive solid points vs their
    nearest target point;
  * segmentation_acc: argmax class accuracy on true positives (CARLA);
  * tracking: precision / recall of mark_track >= threshold detections against the
    marked target instance.

Column layouts follow the export contract (evaluate/results.py docstring and
the datasets' target layouts, data/greater.py and data/carla.py).
'''

import json
import os

import numpy as np

from ..native import nn1_host

__all__ = ['frame_metrics', 'evaluate_results', 'main']

# Target-cloud column layout per dataset kind.
_TARGET_COLS = {
    'greater': dict(inst=3, segm=None, rgb=5, mark=8, width=9),
    'carla': dict(inst=4, segm=5, rgb=7, mark=10, width=11),
}


def _occupancy_labels(xyz, target_xyz, radius):
    if xyz.shape[0] == 0:
        return np.zeros((0,), bool)
    d, _ = nn1_host(xyz, target_xyz)
    return d < radius


def chamfer_distance(a_xyz, b_xyz):
    '''Symmetric mean 1-NN distance; inf when either side is empty.'''
    if a_xyz.shape[0] == 0 or b_xyz.shape[0] == 0:
        return float('inf')
    d_ab, _ = nn1_host(a_xyz, b_xyz)
    d_ba, _ = nn1_host(b_xyz, a_xyz)
    return float(d_ab.mean() + d_ba.mean()) / 2.0


def frame_metrics(output_solid, output_air, target, data_kind='greater',
                  point_occupancy_radius=0.2, color_mode='rgb',
                  predict_segmentation=False, semantic_classes=13,
                  track_threshold=0.5, mark_is_instance_id=False,
                  nn_solid=None, nn_air_d=None):
    '''
    :param output_solid (S, 5+C) array: (x, y, z, t, density, color..., mark, segm?).
    :param output_air (A, 5) compressed or (A, 5+C) uncompressed array.
    :param target (M, 9-11) array in the dataset layout.
    :param mark_is_instance_id: True when the mark column holds merged instance
        ids from multi_track_merge (track_mode='all'; detection = id >= 0) rather
        than raw sigmoid scores. Must come from perform_inference's
        `mark_is_instance_id` — ids can be 0 or 1, so it cannot be inferred from
        the value range.
    :param nn_solid / nn_air_d: optional precomputed 1-NN vs THIS target —
        (distances, indices) over output_solid rows and distances over
        output_air rows (finish_inference's gt path computes them anyway).
        nn1 is row-independent, so results are bit-identical to the in-place
        recomputation; at dense query counts this skips the three dominant
        nn1 passes (solid/air occupancy + chamfer forward + TP row lookup).
    :return dict of scalar metrics.
    '''
    cols = _TARGET_COLS[data_kind]
    target = np.asarray(target)
    tgt_xyz = target[:, :3]
    out = {}

    if nn_solid is not None:
        d_solid, idx_solid = np.asarray(nn_solid[0]), np.asarray(nn_solid[1])
    else:
        d_solid, idx_solid = (
            nn1_host(np.asarray(output_solid)[:, :3], tgt_xyz)
            if np.asarray(output_solid).shape[0]
            else (np.zeros((0,)), np.zeros((0,), np.int64)))
    solid_gt = d_solid < point_occupancy_radius
    if nn_air_d is not None:
        air_gt = np.asarray(nn_air_d) < point_occupancy_radius
    else:
        air_gt = _occupancy_labels(np.asarray(output_air)[:, :3], tgt_xyz,
                                   point_occupancy_radius)
    tp = float(solid_gt.sum())
    fp = float((~solid_gt).sum())
    fn = float(air_gt.sum())
    out['occupancy_precision'] = tp / max(tp + fp, 1.0)
    out['occupancy_recall'] = tp / max(tp + fn, 1.0)
    out['occupancy_f1'] = 2.0 * tp / max(2.0 * tp + fp + fn, 1.0)
    out['occupancy_iou'] = tp / max(tp + fp + fn, 1.0)
    # Chamfer forward leg = the solid 1-NN distances already in hand.
    if d_solid.shape[0] == 0 or tgt_xyz.shape[0] == 0:
        out['chamfer'] = float('inf')
    else:
        d_ba, _ = nn1_host(tgt_xyz, np.asarray(output_solid)[:, :3])
        out['chamfer'] = float(d_solid.mean() + d_ba.mean()) / 2.0

    solid = np.asarray(output_solid)
    if solid.shape[0] and solid_gt.any():
        tp_pts = solid[solid_gt]
        nn_rows = target[idx_solid[solid_gt]]
        if color_mode in ('rgb', 'rgb_nosigmoid'):
            pred_rgb = tp_pts[:, 5:8]
            gt_rgb = nn_rows[:, cols['rgb']:cols['rgb'] + 3]
            out['color_mae'] = float(np.abs(pred_rgb - gt_rgb).mean())
        if predict_segmentation and cols['segm'] is not None:
            pred_seg = tp_pts[:, -semantic_classes:].argmax(axis=-1)
            gt_seg = nn_rows[:, cols['segm']]
            gt_seg = np.where(gt_seg >= semantic_classes, 3, gt_seg)  # 'Other'.
            valid = gt_seg >= 0
            if valid.any():
                out['segmentation_acc'] = float(
                    (pred_seg[valid] == gt_seg[valid]).mean())

        # Tracking. Score mode (track_mode none/one): the mark column is a raw
        # sigmoid detection score for ONE marked instance; binary P/R against
        # the GT mark column. Id mode (track_mode='all' + multi_track_merge):
        # the column holds merged instance ids (-1 = undetected), so score
        # multi-instance identity against the GT instance column — a detected
        # point is correct iff its id matches its nearest target's instance.
        q = {'rgb': 3, 'rgb_nosigmoid': 3, 'hsv': 14, 'bins': 9}[color_mode]
        mark_col = 4 + 1 + q
        if solid.shape[1] > mark_col:
            pred_mark = tp_pts[:, mark_col]
            if mark_is_instance_id:
                gt_inst = nn_rows[:, cols['inst']]
                det = pred_mark >= 0.0
                sup = gt_inst >= 0.0
                if data_kind == 'carla':
                    # CARLA 'all'-mode reruns cover only vehped instances
                    # (semantic 4/10, inference.py rerun selection): score
                    # identity over those — a road query can still hurt
                    # precision if a vehped id is wrongly assigned to it.
                    sup &= np.isin(nn_rows[:, cols['segm']], (4, 10))
                correct = float((det & sup & (pred_mark == gt_inst)).sum())
                if det.any() or sup.any():
                    out['tracking_precision'] = correct / max(float(det.sum()),
                                                              1.0)
                    out['tracking_recall'] = correct / max(float(sup.sum()), 1.0)
            else:
                gt_mark = nn_rows[:, cols['mark']]
                if (gt_mark >= 0.5).any():
                    det = pred_mark >= track_threshold
                    gt_pos = gt_mark >= 0.5
                    tpm = float((det & gt_pos).sum())
                    out['tracking_precision'] = tpm / max(float(det.sum()), 1.0)
                    out['tracking_recall'] = tpm / max(float(gt_pos.sum()), 1.0)
    return out


def evaluate_results(pcl_all_list, data_kind='greater', point_occupancy_radius=0.2,
                     color_mode='rgb', predict_segmentation=False,
                     semantic_classes=13, mark_is_instance_id=False):
    '''
    Aggregate frame_metrics over a list of test steps (see results.load_test_results).
    :param mark_is_instance_id: set True iff the results were exported with
        track_mode='all' (merged instance ids in the mark column).
    :return dict: mean of every metric over all (step, frame) pairs + counts.
    '''
    sums, counts = {}, {}
    n_frames = 0
    for pcl_all in pcl_all_list:
        for record in pcl_all:
            (_, _, output_solid, target, output_air) = record[:5]
            m = frame_metrics(output_solid, output_air, target, data_kind,
                              point_occupancy_radius, color_mode,
                              predict_segmentation, semantic_classes,
                              mark_is_instance_id=mark_is_instance_id)
            n_frames += 1
            for k, v in m.items():
                if np.isfinite(v):
                    sums[k] = sums.get(k, 0.0) + v
                    counts[k] = counts.get(k, 0) + 1
    out = {k: sums[k] / counts[k] for k in sums}
    out['num_frames'] = n_frames
    return out


def main(argv=None):
    import argparse
    from .results import load_test_results
    p = argparse.ArgumentParser(description='Score exported test results.')
    p.add_argument('--input', required=True,
                   help='log-dir prefix or test results dir (see results.py)')
    p.add_argument('--data_kind', default='greater', choices=['greater', 'carla'])
    p.add_argument('--point_occupancy_radius', type=float, default=0.2)
    p.add_argument('--color_mode', default='rgb')
    p.add_argument('--semantic_classes', type=int, default=13)
    p.add_argument('--predict_segmentation', action='store_true')
    p.add_argument('--track_merged', action='store_true',
                   help='results were exported with track_mode=all (mark column '
                        'holds merged instance ids, not sigmoid scores)')
    p.add_argument('--output', default='', help='optional json output path')
    args = p.parse_args(argv)

    results = load_test_results(args.input)
    metrics = evaluate_results(results, args.data_kind, args.point_occupancy_radius,
                               args.color_mode, args.predict_segmentation,
                               args.semantic_classes,
                               mark_is_instance_id=args.track_merged)
    print(json.dumps(metrics, indent=2, sort_keys=True))
    if args.output:
        os.makedirs(os.path.dirname(args.output) or '.', exist_ok=True)
        with open(args.output, 'w') as f:
            json.dump(metrics, f, indent=2, sort_keys=True)
    return metrics


if __name__ == '__main__':
    main()
