'''
Model assembly from a config (port of occlusions4d_tpu/models/factory.py):
head widths per color mode, the latent plumbing between encoder and decoder,
and the sampler arguments. The constructor kwarg dicts are the ones
checkpoints store.
'''

import torch

from .encoder import PointEncoder
from .implicit import LocalImplicitField

__all__ = ['color_channels', 'track_idx', 'decoder_out_channels',
           'build_encoder_args', 'build_decoder_args', 'build_models',
           'build_sampler_args']

_COLOR_Q = {'rgb': 3, 'rgb_nosigmoid': 3, 'hsv': 14, 'bins': 9}


def color_channels(color_mode):
    return _COLOR_Q[color_mode]


def track_idx(color_mode):
    '''Index of mark_track in the decoder output: 1 (density) + Q.'''
    return 1 + _COLOR_Q[color_mode]


def decoder_out_channels(color_mode, segmentation_lw, semantic_classes):
    d_out = 1 + _COLOR_Q[color_mode] + 1
    if segmentation_lw > 0.0:
        d_out += semantic_classes
    return d_out


def build_encoder_args(cfg):
    '''d_in = 8: (x, y, z, R, G, B, t, mark_track).'''
    return dict(
        n_input=cfg.n_points, n_output=cfg.n_points, d_in=8, d_out=1,
        d_feat=cfg.pt_feat_dim, down_blocks=cfg.up_down_blocks,
        up_blocks=cfg.up_down_blocks, transition_factor=cfg.transition_factor,
        pt_num_neighbors=cfg.pt_num_neighbors, pt_norm_type=cfg.pt_norm_type,
        down_neighbors=cfg.down_neighbors, abstract_levels=cfg.abstract_levels,
        skip_connections=False, enable_decoder=False,
        output_featurized=(cfg.local_implicit_mode != 'none'),
        output_global_emb=True, global_dim=cfg.global_size, fps_random_start=True)


def build_decoder_args(cfg):
    d_out = decoder_out_channels(cfg.color_mode, cfg.segmentation_lw,
                                 cfg.semantic_classes)
    local_mode = cfg.local_implicit_mode
    if local_mode == 'none':
        num_local_features = d_latent_local = 0
        d_hidden = d_latent = cfg.global_size
    else:
        num_local_features = cfg.num_cr_local_feats
        d_latent_local = int(cfg.pt_feat_dim * (2 ** cfg.up_down_blocks))
        d_hidden = d_latent = cfg.global_size + d_latent_local
    return dict(
        d_in=4, d_hidden=d_hidden, d_out=d_out, d_latent=d_latent,
        n_blocks=cfg.implicit_mlp_blocks,
        pos_encoding_freqs=8 if cfg.positional_encoding else 0,
        activation=cfg.activation, num_local_features=num_local_features,
        local_mode=local_mode, d_latent_local=d_latent_local,
        cross_attn_neighbors=cfg.cross_attn_neighbors,
        cross_attn_layers=cfg.cross_attn_layers, cr_attn_type=cfg.cr_attn_type)


def build_models(cfg=None, encoder_args=None, decoder_args=None, fused_attention=None,
                 dtype=None):
    '''
    :return (encoder, decoder, encoder_args, decoder_args): freshly initialized
        torch modules (load weights with checkpoint.from_jax_params) plus the
        constructor kwarg dicts.

    `fused_attention` ('auto'|'on'|'off', None = the encoder's default
    'auto') selects the encoder's self-attention path (models/layers.py).
    `dtype` is both modules' compute dtype; None follows the JAX factory
    (occlusions4d_tpu/models/factory.py:88-89): bf16 iff cfg.mixed_precision
    (f32 without a cfg). As in the JAX factory neither is merged into the
    returned args: checkpoints stay path- and dtype-agnostic.
    '''
    if dtype is None:
        dtype = (torch.bfloat16 if cfg is not None and cfg.mixed_precision
                 else torch.float32)
    encoder_args = dict(encoder_args or build_encoder_args(cfg))
    decoder_args = dict(decoder_args or build_decoder_args(cfg))
    extra = {} if fused_attention is None else dict(fused_attention=fused_attention)
    return (PointEncoder(**encoder_args, **extra, dtype=dtype),
            LocalImplicitField(**decoder_args, dtype=dtype), encoder_args, decoder_args)


def build_sampler_args(cfg, data_kind):
    '''SamplerConfig keyword arguments of a training config.'''
    return dict(
        min_z=cfg.min_z, cube_bounds=cfg.cr_cube_bounds,
        point_occupancy_radius=cfg.point_occupancy_radius,
        num_solid=cfg.num_cr_solid,
        num_air=int(cfg.num_cr_solid * cfg.air_sampling_ratio),
        predict_segmentation=cfg.segmentation_lw > 0.0,
        semantic_classes=cfg.semantic_classes,
        predict_tracking=cfg.tracking_lw > 0.0, data_kind=data_kind,
        point_sample_bias=cfg.point_sample_bias, cube_mode=cfg.cube_mode)
