'''
Color spaces of the color heads (port of occlusions4d_tpu/utils/colors.py):
rgb_to_hsv and the hue / color-bin classification targets of the 'hsv' and
'bins' modes (torch, what the losses read), and the visualization decoders
of those heads, model_hsv_to_rgb and model_bins_to_rgb (numpy in and out).
The hsv decoder's hsv_to_rgb is matplotlib.colors.hsv_to_rgb's formula,
kept here so that no plotting package is needed.
'''

import numpy as np
import torch

__all__ = ['rgb_to_hsv', 'hue_bin_targets', 'color_bin_targets', 'hsv_to_rgb',
           'model_hsv_to_rgb', 'model_bins_to_rgb', 'BIN_RGB_COLORS']

# The 'bins' head's nine classes as colours: six saturated hues, then black,
# gray and white.
BIN_RGB_COLORS = np.array([(255, 0, 0), (255, 255, 0), (0, 255, 0),
                           (0, 255, 255), (0, 0, 255), (255, 0, 255),
                           (26, 26, 26), (102, 102, 102), (204, 204, 204)],
                          np.float32) / 255.0


def rgb_to_hsv(rgb, epsilon=1e-10):
    '''(..., 3) rgb in [0, 1] -> (..., 3) (hue degrees [0, 360), sat, value),
    the reference's branchless min/argmin formulation.'''
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    max_rgb = rgb.amax(-1)
    argmin_rgb = torch.argmin(rgb, dim=-1)
    min_rgb = rgb.amin(-1)
    max_min = max_rgb - min_rgb + epsilon
    h1 = 60.0 * (g - r) / max_min + 60.0    # b is the min.
    h2 = 60.0 * (b - g) / max_min + 180.0   # r is the min.
    h3 = 60.0 * (r - b) / max_min + 300.0   # g is the min.
    h = torch.gather(torch.stack([h2, h3, h1], -1), -1, argmin_rgb[..., None])[..., 0]
    s = max_min / (max_rgb + epsilon)
    return torch.stack([h, s, max_rgb], -1)


def hue_bin_targets(rgb, num_classes=12):
    '''Hue classification targets of the 'hsv' mode.
    :return (hue_bin int64 (...), sat (...), val (...)).'''
    hsv = rgb_to_hsv(rgb)
    hue = torch.round(hsv[..., 0] / 360.0 * num_classes).to(torch.int64)
    hue = torch.where(hue == num_classes, torch.zeros_like(hue), hue)
    return hue, hsv[..., 1], hsv[..., 2]


def color_bin_targets(rgb):
    '''9-way targets of the 'bins' mode: 6 saturated hues, then black, gray
    and white. :return (...) int64 in [0, 9).'''
    num_sat = 6
    hsv = rgb_to_hsv(rgb)
    hue = torch.round(hsv[..., 0] / 360.0 * num_sat).to(torch.int64)
    hue = torch.where(hue == num_sat, torch.zeros_like(hue), hue)
    sat, val = hsv[..., 1], hsv[..., 2]
    bland = (sat < 0.3) | (val < 0.3)
    black = (val < 0.2) & bland
    gray = (0.2 <= val) & (val < 0.6) & bland
    white = (0.6 <= val) & bland
    bins = torch.where(black, torch.full_like(hue, num_sat), hue)
    bins = torch.where(gray, torch.full_like(hue, num_sat + 1), bins)
    return torch.where(white, torch.full_like(hue, num_sat + 2), bins)


def hsv_to_rgb(hsv):
    '''(..., 3) hsv in [0, 1] -> (..., 3) rgb, numpy, as
    matplotlib.colors.hsv_to_rgb computes it (the six hue sectors, float64
    for float64 input, else float32 result of a float64 computation).'''
    hsv = np.asarray(hsv)
    if hsv.shape[-1] != 3:
        raise ValueError(f'last dimension of hsv must be 3, got {hsv.shape}')
    in_shape = hsv.shape
    hsv = np.atleast_2d(np.asarray(hsv, dtype=np.promote_types(hsv.dtype, np.float32)))
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    r, g, b = np.empty_like(h), np.empty_like(h), np.empty_like(h)
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    for k, (rr, gg, bb) in enumerate(((v, t, p), (q, v, p), (p, v, t), (p, q, v),
                                      (t, p, v), (v, p, q))):
        idx = i % 6 == k
        r[idx], g[idx], b[idx] = rr[idx], gg[idx], bb[idx]
    idx = s == 0
    r[idx], g[idx], b[idx] = v[idx], v[idx], v[idx]
    return np.stack([r, g, b], axis=-1).reshape(in_shape)


def model_hsv_to_rgb(model_hsv):
    '''Visualization decoder of the 'hsv' head: the argmax of its 12 hue
    logits, sqrt of the saturation, the value. numpy in and out.'''
    model_hsv = np.asarray(model_hsv)
    num_classes = 12
    hue = model_hsv[..., :num_classes].argmax(axis=-1).astype(np.float32) / num_classes
    sat = np.sqrt(model_hsv[..., -2])
    val = model_hsv[..., -1]
    return hsv_to_rgb(np.stack([hue, sat, val], axis=-1))


def model_bins_to_rgb(model_bins):
    '''Visualization decoder of the 'bins' head: the colour of the argmax
    of its 9 logits. numpy in and out.'''
    model_bins = np.asarray(model_bins)
    preds = model_bins[..., :9].argmax(axis=-1).astype(np.int32)
    return BIN_RGB_COLORS[preds]
