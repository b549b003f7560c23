'''
Configuration (own copy of part of occlusions4d_tpu/config.py, same names and
defaults):
  * TrainConfig: the fields that model assembly, evaluation, the train step
    and the train datasets' arguments read. Checkpoints carry the full JAX
    config dict; config_from_dict keeps the fields known here and ignores the
    rest.
  * SharedConfig / TestConfig and test_args: the eval driver's command line,
    flag for flag the JAX package's (str2bool booleans, verify_args checks,
    the test split, resume and log-path resolution). device is 'cuda' (the
    JAX package's 'tpu'), and verify_args refuses any other: the command line
    runs on the card, the CPU run is evaluate.test_driver.main(args,
    device='cpu'). worker_mode 'process' is refused too (threads only).
    gpu_id and query_parallel are kept for the command line's sake.
'''

import argparse
import dataclasses
import multiprocessing
import os
import pathlib
from dataclasses import dataclass

__all__ = ['SharedConfig', 'TrainConfig', 'TestConfig', 'test_args', 'verify_args',
           'str2bool', 'config_from_dict']


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ('yes', 'true', 't', 'y', '1'):
        return True
    if v.lower() in ('no', 'false', 'f', 'n', '0'):
        return False
    raise argparse.ArgumentTypeError('Boolean value expected.')


def _arg2str(v):
    return ('1' if v else '0') if isinstance(v, bool) else str(v)


@dataclass
class SharedConfig:
    device: str = 'cuda'
    num_workers: int = -1
    # 'thread' only (GIL-light decode path); the JAX package's 'process'
    # (fork workers, train loaders only) is refused by verify_args.
    worker_mode: str = 'thread'
    seed: int = 1830
    mixed_precision: bool = False
    # Logging & checkpointing.
    data_path: str = ''
    name: str = ''
    log_root: str = 'logs/'
    resume: str = ''
    checkpoint_root: str = 'checkpoints/'
    checkpoint_format: str = 'pkl'
    # Data.
    use_data_frac: float = 1.0
    sample_bias: str = 'none'
    sb_occl_frame_shift: int = 2
    # Observability: wandb is opt-in and degrades to file logging.
    use_wandb: bool = False


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
    frame_skip: int = 4
    min_z: float = -1.0
    pt_cube_bounds: float = 5.0
    cr_cube_bounds: float = -1.0
    cube_mode: int = 4
    correct_ego_motion: bool = True
    correct_origin_ground: bool = True
    # The train datasets' selection (data/loader.py::_train_dset_args).
    name: str = ''
    use_data_frac: float = 1.0
    sample_bias: str = 'none'
    sb_occl_frame_shift: int = 2
    oversample_vehped_target: bool = False
    export_visuals: bool = False
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


@dataclass
class TestConfig(SharedConfig):
    __test__ = False  # not a pytest class.
    ss_frame_step: int = 3
    force_view_idx: int = -1
    log_path: str = 'auto'
    gpu_id: int = 0               # kept for the command line's sake.
    epoch: int = -1
    implicit_batch_size: int = 65536
    sample_implicit: bool = True
    num_sample: int = 262144
    point_sample_mode: str = 'random'
    store_pcl: bool = True
    density_threshold: float = 0.5
    store_activations: bool = False
    save_metrics: bool = False
    save_gt: bool = False
    track_mode: str = 'none'
    use_json: bool = False
    live_occl_mode: str = 'normal'
    query_parallel: int = -1      # one device: -1 or 1 (evaluate/inference.py).
    # Eval numerics (evaluate/inference.py::resolve_precision): 'fast' (the
    # bf16 kernels), 'f32' / 'highest' (the f32 kernels), 'auto' = 'f32'.
    eval_precision: str = 'auto'
    # Pipelined eval loop: a post-processing worker thread runs frame i's host
    # stages (fetch, merge, 1-NN labels, metrics, export) while frame i+1's
    # kernels run. Metric values and artifacts are bit-identical either way.
    eval_overlap: bool = True
    tag: str = ''
    test_tag: str = ''
    train_tag: str = ''
    # Back-filled from the checkpoint's train config (evaluate/test_driver.py).
    min_z: float = -1.0
    pt_cube_bounds: float = 5.0
    cr_cube_bounds: float = 5.0
    cube_mode: int = 4
    color_mode: str = 'rgb'
    segmentation_lw: float = 0.0
    tracking_lw: float = 0.0
    point_occupancy_radius: float = 0.2
    semantic_classes: int = 13


def _add_fields(parser, cls):
    for f in dataclasses.fields(cls):
        if f.name in ('tag', 'test_tag', 'train_tag'):
            continue
        # isinstance, not `in (True, False)`: 0.0 == False would turn float
        # flags with 0/1 defaults into booleans.
        if isinstance(f.default, bool):
            parser.add_argument(f'--{f.name}', default=f.default, type=str2bool)
        else:
            parser.add_argument(f'--{f.name}', default=f.default, type=type(f.default))


def verify_args(args, is_train=False):
    '''The JAX package's argument checks and num_workers default (eval side;
    the train side waits for the port's train driver).'''
    assert not is_train, 'the train command line is not part of the port yet'
    if args.device != 'cuda':
        raise ValueError(f'--device {args.device}: the eval command line runs on the card '
                         "('cuda'); the CPU run is test_driver.main(args, device='cpu')")
    if args.worker_mode != 'thread':
        raise ValueError(f'--worker_mode {args.worker_mode}: the port\'s loader workers are '
                         "threads ('thread'); the JAX package's fork processes are not ported")
    assert getattr(args, 'checkpoint_format', 'pkl') in ('pkl', 'orbax')
    assert args.sample_bias in ('none', 'move', 'occl', 'move_occl', 'occl_move')
    if args.num_workers < 0:
        args.num_workers = max(multiprocessing.cpu_count() // 4 - 6, 1)
    assert args.point_sample_mode in ('random', 'grid')
    assert args.eval_precision in ('auto', 'fast', 'f32', 'highest')
    return args


def test_args(argv=None):
    parser = argparse.ArgumentParser()
    _add_fields(parser, TestConfig)
    ns = parser.parse_args(argv)
    args = TestConfig(**vars(ns))
    verify_args(args, is_train=False)

    # Point at the test split when present.
    if args.data_path and os.path.exists(os.path.join(args.data_path, 'test')):
        args.data_path = os.path.join(args.data_path, 'test')

    if args.resume and not (os.path.exists(args.resume) and os.path.isfile(args.resume)):
        from .checkpoint import resolve_resume_path
        args.resume = resolve_resume_path(args.resume, args.checkpoint_root)

    if args.log_path == 'auto':
        args.log_path = str(pathlib.Path(str(args.resume).replace('checkpoints', 'logs')))
        keys = {'use_data_frac': 'df', 'sample_bias': 'sb', 'num_sample': 'ns',
                'point_sample_mode': 'sm', 'density_threshold': 'dt',
                'store_activations': 'sa', 'save_metrics': 'sm', 'track_mode': 'tm',
                'use_json': 'uj'}
        test_tag = (args.name + '_') if args.name else ''
        test_tag += '_'.join(k2 + _arg2str(getattr(args, k)) for k, k2 in keys.items())
        args.test_tag = test_tag
    else:
        args.log_path = str(pathlib.Path(args.log_path).parent)
        args.test_tag = str(pathlib.Path(args.log_path).name)

    args.log_root = str(pathlib.Path(args.log_path).parent)
    args.train_tag = str(pathlib.Path(args.log_path).name)
    args.tag = args.train_tag
    return args


def config_from_dict(cls, d):
    '''Build a config from a dict, ignoring unknown keys.'''
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in (d or {}).items() if k in names})
