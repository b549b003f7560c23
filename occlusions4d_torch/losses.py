'''
Objective functions of the 4D field (port of occlusions4d_tpu/losses.py).
Every masked mean is a mask-weighted mean (static shapes, 0 on an empty mask):
  * density: sigmoid BCE on channel 0 over all queries;
  * color, over solid and color-available queries, per mode: rgb /
    rgb_nosigmoid L1 on channels 1:4; hsv 12-bin hue CE (where saturated and
    bright, and only with >= 16 such points) / 2 plus sat and val L1, all / 3;
    bins 9-way CE / 3;
  * segmentation: CE on the last semantic_classes channels where segm >= 0;
  * tracking: sigmoid BCE on the track channel where solid and track >= 0.
Each loss is computed per (example, frame) slice and then averaged over the
slices, weighted by the sampler's per-frame validity. The element losses
follow optax's formulas (log-sigmoid BCE, logsumexp CE).
'''

import dataclasses

import torch
from torch.nn import functional as F

from .models.factory import track_idx
from .parallel import all_reduce_sum
from .utils.colors import color_bin_targets, hue_bin_targets

__all__ = ['LossConfig', 'per_slice_losses', 'per_example_losses', 'total_loss']


@dataclasses.dataclass(frozen=True)
class LossConfig:
    color_mode: str = 'rgb'
    semantic_classes: int = 13
    density_lw: float = 1.0
    color_lw: float = 0.0
    segmentation_lw: float = 0.0
    tracking_lw: float = 0.0


def _sigmoid_bce(logits, labels):
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def _softmax_ce(logits, labels):
    label_logits = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - label_logits


def _masked_mean(values, mask):
    '''Mean of values over mask along the last axis; 0 where the mask is empty.'''
    mask = mask.to(values.dtype)
    denom = mask.sum(-1)
    return torch.where(denom > 0, (values * mask).sum(-1) / torch.clamp(denom, min=1.0),
                       torch.zeros_like(denom))


def _density_loss(output, target):
    return _sigmoid_bce(output[..., 0], target[..., 0]).mean(-1)


def _color_loss(output, target, cfg):
    mask = (target[..., 0] >= 0.1) & (target[..., 1] >= 0.0)
    rgb_t = torch.clamp(target[..., 1:4], 0.0, 1.0)
    if cfg.color_mode in ('rgb', 'rgb_nosigmoid'):
        l1 = (output[..., 1:4] - target[..., 1:4]).abs().mean(-1)
        return _masked_mean(l1, mask)
    if cfg.color_mode == 'hsv':
        n = 12
        hue_t, sat_t, val_t = hue_bin_targets(rgb_t, n)
        hue_mask = mask & (sat_t >= 0.2) & (val_t >= 0.2)
        loss_hue = _masked_mean(_softmax_ce(output[..., 1:1 + n], hue_t), hue_mask) / 2.0
        loss_hue = torch.where(hue_mask.sum(-1) >= 16, loss_hue, torch.zeros_like(loss_hue))
        loss_sat = _masked_mean((output[..., 1 + n] - sat_t).abs(), mask)
        loss_val = _masked_mean((output[..., 2 + n] - val_t).abs(), mask)
        return (loss_hue + loss_sat + loss_val) / 3.0
    if cfg.color_mode == 'bins':
        ce = _softmax_ce(output[..., 1:10], color_bin_targets(rgb_t))
        return _masked_mean(ce, mask) / 3.0
    raise ValueError(cfg.color_mode)


def _segm_loss(output, target, cfg):
    segm_t = target[..., -1].to(torch.int64)
    logits = output[..., -cfg.semantic_classes:]
    ce = _softmax_ce(logits, torch.clamp(segm_t, 0, cfg.semantic_classes - 1))
    return _masked_mean(ce, segm_t >= 0)


def _track_loss(output, target, cfg):
    mask = (target[..., 0] >= 0.1) & (target[..., 4] >= 0.0)
    bce = _sigmoid_bce(output[..., track_idx(cfg.color_mode)],
                       torch.clamp(target[..., 4], 0.0, 1.0))
    return _masked_mean(bce, mask)


def per_slice_losses(output, target, cfg: LossConfig):
    '''
    :param output (..., N, C) decoder output after the train-time squash;
        target (..., N, 6) (density, R, G, B, mark_track, segm).
    :return dict of (...) losses per slice. A term with zero weight is not
        computed (with segmentation off the head has no segm channels).
    '''
    z = torch.zeros(output.shape[:-2], dtype=output.dtype, device=output.device)
    return dict(
        dens=_density_loss(output, target) if cfg.density_lw > 0 else z,
        rgb=_color_loss(output, target, cfg) if cfg.color_lw > 0 else z,
        segm=_segm_loss(output, target, cfg) if cfg.segmentation_lw > 0 else z,
        track=_track_loss(output, target, cfg) if cfg.tracking_lw > 0 else z)


def per_example_losses(output, target, cfg: LossConfig, frame_weight=None, group=None):
    '''
    :param output (B, T, N, C), target (B, T, N, 6).
    :param frame_weight (B, T) bool/float or None: per-(example, frame)
        validity; a degenerate frame gets weight 0.
    :param group: a data-parallel group (parallel.Group) whose ranks hold
        the other rows of the global batch, or None.
    :return dict of scalar losses, the (weighted) mean over the slices. With
        a group and a frame_weight, each rank's share of the global weighted
        mean: its weighted sum over the all-reduced weight (averaging the
        ranks' own means would be wrong wherever their weights differ); the
        shares sum to the global mean.
    '''
    sliced = per_slice_losses(output, target, cfg)
    if frame_weight is None:
        return {k: v.mean() for k, v in sliced.items()}
    w = frame_weight.to(output.dtype)
    denom = torch.clamp(all_reduce_sum(w.sum(), group), min=1.0)
    return {k: (v * w).sum() / denom for k, v in sliced.items()}


def total_loss(losses, cfg: LossConfig):
    '''Lambda-weighted sum.'''
    return (losses['rgb'] * cfg.color_lw + losses['dens'] * cfg.density_lw
            + losses['segm'] * cfg.segmentation_lw + losses['track'] * cfg.tracking_lw)
