'''
Color-space targets of the color heads (port of the parts of
occlusions4d_tpu/utils/colors.py that the losses read): rgb_to_hsv and the
hue / color-bin classification targets of the 'hsv' and 'bins' modes.
'''

import torch

__all__ = ['rgb_to_hsv', 'hue_bin_targets', 'color_bin_targets']


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
