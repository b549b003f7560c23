'''
The training-configuration fields that model assembly and evaluation read
(own copy of part of occlusions4d_tpu/config.py::TrainConfig, same names and
defaults). Checkpoints carry the full JAX config dict; config_from_dict keeps
the fields known here and ignores the rest.
'''

import dataclasses
from dataclasses import dataclass

__all__ = ['TrainConfig', 'config_from_dict']


@dataclass
class TrainConfig:
    # Point transformer architecture.
    up_down_blocks: int = 3
    transition_factor: int = 3
    pt_feat_dim: int = 32
    pt_num_neighbors: int = 14
    pt_norm_type: str = 'none'
    down_neighbors: int = 8
    global_size: int = 128
    num_cr_local_feats: int = 8
    # Data and scene cuboids.
    n_points: int = 8192
    min_z: float = -1.0
    cr_cube_bounds: float = -1.0
    cube_mode: int = 4
    # Continuous representation.
    positional_encoding: bool = True
    activation: str = 'relu'
    implicit_mlp_blocks: int = 6
    local_implicit_mode: str = 'attention'
    cross_attn_layers: int = 1
    cross_attn_neighbors: int = 12
    cr_attn_type: str = 'c'
    abstract_levels: int = 1
    # Output heads.
    color_mode: str = 'rgb'
    semantic_classes: int = 13
    segmentation_lw: float = 0.0
    tracking_lw: float = 0.0
    point_occupancy_radius: float = 0.2


def config_from_dict(cls, d):
    '''Build a config from a dict, ignoring unknown keys.'''
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in (d or {}).items() if k in names})
