'''
Scene cuboids and mask-based point filters (own copy of
occlusions4d_tpu/ops/bounds.py). Filters return masks instead of compacting,
so shapes never depend on the data.
'''

from typing import NamedTuple

import numpy as np
import torch

__all__ = ['Cuboid', 'greater_bounds', 'carla_input_bounds', 'carla_output_bounds',
           'blind_sample_bounds', 'cuboid_mask', 'greater_floor_mask']


class Cuboid(NamedTuple):
    x_min: float
    x_max: float
    y_min: float
    y_max: float
    z_min: float
    z_max: float

    @property
    def volume(self):
        return ((self.x_max - self.x_min) * (self.y_max - self.y_min)
                * (self.z_max - self.z_min))


def greater_bounds(other_bounds, min_z):
    '''GREATER symmetric cube.'''
    b = float(other_bounds)
    return Cuboid(-b, b, -b, b, float(min_z), b)


# CARLA cuboids by cube_mode: coefficients on other_bounds for
# (x_min, x_max, y_min, y_max, z_max); the input cuboid reaches backwards.
_CARLA_INPUT = {
    1: (-0.5, 2.0, -1.0, 1.0, 0.5),
    2: (-0.6, 2.4, -0.8, 0.8, 0.6),
    3: (-0.7, 2.2, -1.0, 1.0, 0.5),
    4: (-0.7, 2.5, -1.0, 1.0, 0.5),
}
_CARLA_OUTPUT = {
    1: (0.0, 2.0, -1.0, 1.0, 0.5),
    2: (0.0, 2.4, -0.8, 0.8, 0.4),
    3: (0.0, 2.2, -1.0, 1.0, 0.4),
    4: (0.0, 2.5, -1.0, 1.0, 0.4),
}


def carla_input_bounds(other_bounds, min_z, cube_mode=4):
    cx0, cx1, cy0, cy1, cz1 = _CARLA_INPUT[int(cube_mode)]
    b = float(other_bounds)
    return Cuboid(b * cx0, b * cx1, b * cy0, b * cy1, float(min_z), b * cz1)


def carla_output_bounds(other_bounds, min_z, cube_mode=4, padding=0.0):
    '''Output cube; padding expands x/y in 4 directions only.'''
    cx0, cx1, cy0, cy1, cz1 = _CARLA_OUTPUT[int(cube_mode)]
    b, p = float(other_bounds), float(padding)
    return Cuboid(b * cx0 - p, b * cx1 + p, b * cy0 - p, b * cy1 + p,
                  float(min_z), b * cz1)


def blind_sample_bounds(data_kind, cube_bounds, min_z, cube_mode=4):
    '''Cuboid in which blind query points are drawn: the symmetric cube for
    GREATER, the output cuboid (x > 0) for CARLA.'''
    if data_kind == 'greater':
        return greater_bounds(cube_bounds, min_z)
    if data_kind == 'carla':
        return carla_output_bounds(cube_bounds, min_z, cube_mode=cube_mode)
    raise ValueError(data_kind)


def cuboid_mask(pcl, cuboid: Cuboid):
    '''(..., C>=3) points -> (...) bool, True inside the closed cuboid.'''
    x, y, z = pcl[..., 0], pcl[..., 1], pcl[..., 2]
    m = (cuboid.x_min <= x) & (x <= cuboid.x_max)
    m &= (cuboid.y_min <= y) & (y <= cuboid.y_max)
    m &= (cuboid.z_min <= z) & (z <= cuboid.z_max)
    return m


def greater_floor_mask(pcl):
    '''Removes the curving floor of GREATER scenes (tensor or numpy array).'''
    if isinstance(pcl, np.ndarray):
        inv_pyramid = np.maximum(np.abs(pcl[..., 0]), np.abs(pcl[..., 1]))
    else:
        inv_pyramid = torch.maximum(pcl[..., 0].abs(), pcl[..., 1].abs())
    return pcl[..., 2] > (inv_pyramid - 4.5) / 3.5
