'''
The training-configuration fields that model assembly, evaluation and the
train step read (own copy of part of occlusions4d_tpu/config.py::TrainConfig,
same names and defaults). Checkpoints carry the full JAX config dict; config_from_dict keeps
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
    n_data_rnd: int = 16384
    video_len: int = 6
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
    # Training. mixed_precision trains as the JAX package does: both networks
    # built in bf16 (bf16 linear layers over f32 parameters, the encoder's
    # fused self-attention in its bf16 mode; models/layers.py) and AdamW's
    # eps 1e-4 (train.py); a checkpoint trained so is still evaluated in f32,
    # as the JAX engine evaluates it (evaluate/inference.py).
    # fused_decoder_dtype is the compute dtype of the fused decoder's kernels
    # in the train step, forward and backward (JAX's name and default):
    # 'bf16', 'f32', or 'auto', which is bf16 on a TPU in the JAX package
    # and f32 everywhere in the port (pipeline.py).
    mixed_precision: bool = False
    fused_decoder_dtype: str = 'auto'
    seed: int = 1830
    batch_size: int = 8
    learn_rate: float = 1e-3
    lr_decay: float = 0.4
    num_epochs: int = 20
    gradient_clip: float = 0.2
    # Loss and query sampling.
    density_lw: float = 1.0
    color_lw: float = 0.0
    point_occupancy_radius: float = 0.2
    num_cr_solid: int = 7168
    air_sampling_ratio: float = 1.5
    point_sample_bias: str = 'none'
    past_frames: int = 2
    future_frames: int = 0


def config_from_dict(cls, d):
    '''Build a config from a dict, ignoring unknown keys.'''
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in (d or {}).items() if k in names})
