'''
Scene cuboids of blind query sampling (own copy of the numpy parts of
occlusions4d_tpu/ops/bounds.py that evaluation reads).
'''

from typing import NamedTuple

__all__ = ['Cuboid', 'greater_bounds', 'carla_output_bounds', 'blind_sample_bounds']


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


# CARLA output cuboids by cube_mode: coefficients on other_bounds for
# (x_min, x_max, y_min, y_max, z_max).
_CARLA_OUTPUT = {
    1: (0.0, 2.0, -1.0, 1.0, 0.5),
    2: (0.0, 2.4, -0.8, 0.8, 0.4),
    3: (0.0, 2.2, -1.0, 1.0, 0.4),
    4: (0.0, 2.5, -1.0, 1.0, 0.4),
}


def carla_output_bounds(other_bounds, min_z, cube_mode=4, padding=0.0):
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
