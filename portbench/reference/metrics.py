'''
The reference of the evaluation's frame metrics: occupancy precision,
recall, F1 and IoU, chamfer distance, colour error, segmentation accuracy
and tracking precision and recall of one frame, as the port's
evaluate/metrics.py scores a frame of the eval loop (the solid set split at
density 0.5, the target's layout by dataset kind), with a plain blockwise
1-NN in PyTorch on the outputs' device: per-pair differences squared and
summed in x, y, z order, the lowest index of the smallest distance.

The control (tf32) rounds the points' coordinates to TF32 (10 mantissa
bits, the nearest precision below f32) before the same 1-NN.
'''

import math

import numpy as np
import torch

_PLAIN_CHUNK = 2 ** 25  # distance entries per slab.
DENSITY_THRESHOLD = 0.5
_COLOR_Q = {'rgb': 3, 'rgb_nosigmoid': 3, 'hsv': 14, 'bins': 9}
_TARGET_COLS = {'greater': dict(inst=3, segm=None, rgb=5, mark=8),
                'carla': dict(inst=4, segm=5, rgb=7, mark=10)}


def round_tf32(x):
    '''f32 values rounded to TF32's 10 mantissa bits (to nearest, ties away
    from zero).'''
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1fff).view(torch.float32)


def nn1(query, keys, tf32=False):
    '''(dists (N,) f32, idx (N,) int64) of each query row's nearest key row;
    with tf32 the coordinates rounded to TF32 first.'''
    q = query[:, :3].to(torch.float32).contiguous()
    k = keys[:, :3].to(torch.float32).contiguous()
    if tf32:
        q, k = round_tf32(q), round_tf32(k)
    N, M = q.shape[0], k.shape[0]
    rows = max(1, _PLAIN_CHUNK // max(M, 1))
    ds, ids = [], []
    for r0 in range(0, N, rows):
        qc = q[r0:r0 + rows]
        dx = k[None, :, 0] - qc[:, None, 0]
        dy = k[None, :, 1] - qc[:, None, 1]
        dz = k[None, :, 2] - qc[:, None, 2]
        d = dx * dx + dy * dy + dz * dz
        vals, idx = d.min(-1)
        ds.append(vals)
        ids.append(idx)
    if not ds:
        return q.new_zeros((0,)), torch.zeros((0,), dtype=torch.int64, device=q.device)
    return torch.sqrt(torch.cat(ds)), torch.cat(ids)


def frame_metrics(output, queries, target, cfg, tf32=False):
    '''The metrics of one frame. :param output (P, C) squashed outputs (a
    tensor; its device runs the 1-NN); queries (P, 4); target (M, E) valid
    target rows; cfg the configuration dict. :return {name: float}.'''
    dev = output.device
    out = output.to(torch.float32)
    q = torch.as_tensor(np.asarray(queries), dtype=torch.float32, device=dev)
    tgt = torch.as_tensor(np.asarray(target), dtype=torch.float32, device=dev)
    kind, radius = cfg['data_kind'], cfg['point_occupancy_radius']
    cols = _TARGET_COLS[kind]
    solid_sel = out[:, 0] >= DENSITY_THRESHOLD
    solid = torch.cat([q, out], -1)[solid_sel]
    air_xyz = q[~solid_sel, :3]
    tgt_xyz = tgt[:, :3]
    m = {}
    if solid.shape[0]:
        d_solid, idx_solid = nn1(solid, tgt_xyz, tf32)
    else:
        d_solid = q.new_zeros((0,))
        idx_solid = torch.zeros((0,), dtype=torch.int64, device=dev)
    solid_gt = d_solid < radius
    air_gt = (nn1(air_xyz, tgt_xyz, tf32)[0] < radius if air_xyz.shape[0]
              else torch.zeros((0,), dtype=torch.bool, device=dev))
    tp, fp, fn = float(solid_gt.sum()), float((~solid_gt).sum()), float(air_gt.sum())
    m['occupancy_precision'] = tp / max(tp + fp, 1.0)
    m['occupancy_recall'] = tp / max(tp + fn, 1.0)
    m['occupancy_f1'] = 2.0 * tp / max(2.0 * tp + fp + fn, 1.0)
    m['occupancy_iou'] = tp / max(tp + fp + fn, 1.0)
    if d_solid.shape[0] == 0 or tgt_xyz.shape[0] == 0:
        m['chamfer'] = math.inf
    else:
        d_back, _ = nn1(tgt_xyz, solid, tf32)
        m['chamfer'] = (float(d_solid.double().mean()) + float(d_back.double().mean())) / 2.0
    if solid.shape[0] and bool(solid_gt.any()):
        tp_rows = solid[solid_gt]
        nn_rows = tgt[idx_solid[solid_gt]]
        if cfg['color_mode'] in ('rgb', 'rgb_nosigmoid'):
            m['color_mae'] = float((tp_rows[:, 5:8] - nn_rows[:, cols['rgb']:cols['rgb'] + 3])
                                   .abs().double().mean())
        n_cls = cfg['semantic_classes']
        if cfg['segmentation_lw'] > 0.0 and cols['segm'] is not None:
            pred = tp_rows[:, -n_cls:].argmax(-1)
            gt = nn_rows[:, cols['segm']]
            gt = torch.where(gt >= n_cls, torch.full_like(gt, 3.0), gt)
            valid = gt >= 0
            if bool(valid.any()):
                m['segmentation_acc'] = float((pred[valid] == gt[valid].long()).double().mean())
        mark_col = 4 + 1 + _COLOR_Q[cfg['color_mode']]
        if solid.shape[1] > mark_col:
            gt_pos = nn_rows[:, cols['mark']] >= 0.5
            if bool(gt_pos.any()):
                det = tp_rows[:, mark_col] >= 0.5
                hit = float((det & gt_pos).sum())
                m['tracking_precision'] = hit / max(float(det.sum()), 1.0)
                m['tracking_recall'] = hit / max(float(gt_pos.sum()), 1.0)
    return m


def _number(v):
    return math.nan if v is None else float(v)


def gap(metrics, ref):
    '''The largest |value - reference| / max(1, |reference|) over the
    reference's metrics (the eval loop's step and time_idx left out); inf
    where the names differ or one side is finite and the other not.'''
    names = {k for k in metrics if k not in ('step', 'time_idx')}
    if names != set(ref):
        return math.inf
    worst = 0.0
    for k in names:
        a, b = _number(metrics[k]), _number(ref[k])
        if not (math.isfinite(a) and math.isfinite(b)):
            if math.isfinite(a) or math.isfinite(b):
                return math.inf
            continue
        worst = max(worst, abs(a - b) / max(1.0, abs(b)))
    return worst
