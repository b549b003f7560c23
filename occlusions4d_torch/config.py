'''
Configuration (own copy of occlusions4d_tpu/config.py, same names, types and
defaults but for device):
  * SharedConfig / TrainConfig and train_args: the train driver's command
    line (python -m occlusions4d_torch.train), flag for flag the JAX
    package's, with its auto tag, output path and `--resume v6` resolution.
    device is 'cuda' (the JAX package's 'tpu'); '--device cpu' trains with
    the plain versions. --checkpoint_format orbax parses, and verify_args
    raises NotImplementedError for it (orbax is not installed where the port
    runs). --check_numerics, --watch_networks / --use_wandb, --profile_steps
    and --fused_decoder off train as in the JAX package (train.py).
    Checkpoints carry the full config dict; config_from_dict keeps the
    fields known here and ignores the rest. --resume takes either package's
    .pkl, a reference .pth (a warm start: weights and epoch) or a run
    directory (checkpoint.resolve_checkpoint_file).
  * TestConfig and test_args: the eval driver's command line, flag for flag
    the JAX package's (str2bool booleans, verify_args checks, the test
    split, resume and log-path resolution). Its device is 'cuda' only: the
    CPU run is evaluate.test_driver.main(args, device='cpu'). worker_mode
    'process' (fork workers) is the train side's only, as in the JAX
    package: the test loader is built after load_models has started the
    CUDA runtime. gpu_id is kept for the command line's sake;
    --query_parallel N shards each decode chunk's queries over N devices
    (evaluate/inference.py).
    --data_parallel N trains on N ranks (train.main: spawned, or under
    torchrun); a batch that does not divide over them raises here, as the
    JAX Trainer raises.
'''

import argparse
import dataclasses
import multiprocessing
import os
import pathlib
from dataclasses import dataclass

__all__ = ['SharedConfig', 'TrainConfig', 'TestConfig', 'train_args', 'test_args',
           'verify_args', 'str2bool', 'config_from_dict']


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
    # 'thread' (GIL-light decode path) or 'process' (fork workers, train
    # loaders only; data/loader.py). The eval side refuses 'process'.
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
class TrainConfig(SharedConfig):
    batch_size: int = 8
    output_path: str = 'auto'

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

    # Continuous representation.
    positional_encoding: bool = True
    activation: str = 'relu'
    implicit_mlp_blocks: int = 6
    use_global_embedding: bool = True
    local_implicit_mode: str = 'attention'
    cross_attn_layers: int = 1
    cross_attn_neighbors: int = 12
    cr_attn_type: str = 'c'
    abstract_levels: int = 1

    # Output heads.
    color_mode: str = 'rgb'
    semantic_classes: int = 13

    # Training. mixed_precision (SharedConfig) trains as the JAX package
    # does: both networks built in bf16 (bf16 linear layers over f32
    # parameters, the encoder's fused self-attention in its bf16 mode;
    # models/layers.py) and AdamW's eps 1e-4 (train.py); a checkpoint
    # trained so is still evaluated in f32, as the JAX engine evaluates it.
    parallel_pipeline: bool = True
    learn_rate: float = 1e-3
    lr_decay: float = 0.4
    num_epochs: int = 20
    start_epoch: int = 0
    gradient_clip: float = 0.2

    # Loss and query sampling.
    density_lw: float = 1.0
    color_lw: float = 0.0
    segmentation_lw: float = 0.0
    tracking_lw: float = 0.0
    point_occupancy_radius: float = 0.2
    num_cr_solid: int = 7168
    air_sampling_ratio: float = 1.5
    point_sample_bias: str = 'none'
    oversample_vehped_target: bool = False
    past_frames: int = 2
    future_frames: int = 0

    # The JAX package's additions, under its names. data_parallel: ranks of
    # data-parallel training (train.main; -1 the largest divisor of the batch
    # that the host's cards hold); query_parallel: devices of the dense eval
    # (the eval side's; the train side parses it and leaves it unused, as
    # the JAX package does). check_numerics, watch_networks and
    # profile_steps: train.py.
    data_parallel: int = -1
    query_parallel: int = 1
    # The decoder in the train step: 'auto' and 'on' take the fused decoder
    # (models/fused.py: kernels on the card, plain versions on the CPU)
    # where supports_fused covers the configuration; 'off' the module path
    # (the decoder's modules, each frame recomputed in the backward;
    # pipeline.py), as --check_numerics does.
    fused_decoder: str = 'auto'
    # The fused decoder's compute dtype, forward and backward: 'bf16',
    # 'f32', or 'auto', which is bf16 on a TPU in the JAX package and f32
    # everywhere in the port (pipeline.py).
    fused_decoder_dtype: str = 'auto'
    export_visuals: bool = False  # load images for early-epoch gallery exports.
    viz_interval: int = 80        # intermediate-export cadence (train.py).
    watch_networks: bool = False
    check_numerics: bool = False
    profile_steps: int = 0
    tag: str = ''


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
    query_parallel: int = -1      # eval devices, -1 all (evaluate/inference.py).
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


def _refused_train_flags(args):
    '''The train flags the port parses but does not implement, each with
    its ROADMAP Queue 1 item: [(flag, item)].'''
    out = []
    if args.checkpoint_format == 'orbax':
        out.append(('--checkpoint_format orbax', 5))
    return out


def verify_args(args, is_train=False):
    '''The JAX package's argument checks and num_workers default. The train
    side accepts --device cuda (the default) or cpu (the plain versions) and
    raises NotImplementedError, naming the ROADMAP item, for
    --checkpoint_format orbax; the eval side takes cuda and thread workers
    only.'''
    assert args.worker_mode in ('thread', 'process')
    assert getattr(args, 'checkpoint_format', 'pkl') in ('pkl', 'orbax')
    assert args.sample_bias in ('none', 'move', 'occl', 'move_occl', 'occl_move')
    if not is_train:
        if args.device != 'cuda':
            raise ValueError(f'--device {args.device}: the eval command line runs on the '
                             "card ('cuda'); the CPU run is test_driver.main(args, "
                             "device='cpu')")
        if args.worker_mode != 'thread':
            raise ValueError(f'--worker_mode {args.worker_mode}: the test loader\'s workers '
                             "are threads ('thread'); fork workers ('process') are the train "
                             'loaders\' only')
        if args.num_workers < 0:
            args.num_workers = max(multiprocessing.cpu_count() // 4 - 6, 1)
        assert args.point_sample_mode in ('random', 'grid')
        assert args.eval_precision in ('auto', 'fast', 'f32', 'highest')
        return args

    if args.device not in ('cuda', 'cpu'):
        raise ValueError(f"--device {args.device}: the port trains on 'cuda' or 'cpu'")
    if args.num_workers < 0:
        args.num_workers = max(int(multiprocessing.cpu_count() * 0.9) - 12, 2)
    if args.cr_cube_bounds <= 0.0:
        args.cr_cube_bounds = args.pt_cube_bounds
    while len(args.cr_attn_type) < args.cross_attn_layers:
        assert len(args.cr_attn_type) != 0
        args.cr_attn_type = args.cr_attn_type + args.cr_attn_type
    assert 256 <= args.n_points <= 65536
    assert args.pt_norm_type in ('none', 'batch', 'layer')
    assert args.past_frames + args.future_frames <= args.video_len
    assert args.future_frames < args.video_len
    assert args.local_implicit_mode in ('none', 'feature', 'attention')
    assert args.color_mode in ('rgb', 'rgb_nosigmoid', 'hsv', 'bins')
    assert args.fused_decoder in ('auto', 'on', 'off')
    assert args.fused_decoder_dtype in ('auto', 'bf16', 'f32')
    if args.data_parallel > 1 and args.batch_size % args.data_parallel:
        raise ValueError(
            f'batch_size={args.batch_size} is not divisible by the data-parallel mesh size '
            f'{args.data_parallel}; every step would fail at shard time (and be swallowed by '
            f'the exception tolerance). Adjust --batch_size or --data_parallel.')
    refused = _refused_train_flags(args)
    if refused:
        raise NotImplementedError('; '.join(
            f'{flag} is not part of the port (ROADMAP.md Queue 1 item {item})'
            for flag, item in refused))
    return args


def _auto_train_tag(args):
    '''Experiment tag encoding key hyperparameters.'''
    keys = {'mixed_precision': 'mp', 'up_down_blocks': 'ud', 'n_points': 'np',
            'video_len': 'vl', 'frame_skip': 'fs', 'density_lw': 'dl',
            'color_lw': 'cl', 'segmentation_lw': 'sl', 'tracking_lw': 'tl'}
    tag = args.name + '_'
    tag += '_'.join(k2 + _arg2str(getattr(args, k)) for k, k2 in keys.items())
    if args.use_data_frac < 1.0:
        tag += f'_df{_arg2str(args.use_data_frac)}'
    tag += f'_gs{_arg2str(args.global_size) if args.use_global_embedding else 0}'
    tag += f'_a{args.activation[:2]}'
    tag += f'_im{args.local_implicit_mode[:2]}'
    tag += f'_pt{args.past_frames}_{args.future_frames}'
    return tag


def train_args(argv=None):
    '''The train command line (python -m occlusions4d_torch.train), flag for
    flag the JAX package's: the auto tag and output path, and `--resume v6`
    resolved to the unique checkpoints/v6_*/ directory's checkpoint.pkl, or
    its checkpoint.pth where it holds no pkl epochs (a directory whose
    newest epoch is an orbax store raises).'''
    parser = argparse.ArgumentParser()
    _add_fields(parser, TrainConfig)
    ns = parser.parse_args(argv)
    args = TrainConfig(**vars(ns))
    verify_args(args, is_train=True)

    if args.output_path == 'auto':
        args.tag = _auto_train_tag(args)
        args.output_path = os.path.join(args.checkpoint_root, args.tag)

    if args.resume and not (os.path.exists(args.resume) and os.path.isfile(args.resume)):
        from .checkpoint import resolve_checkpoint_file, resolve_resume_path
        args.resume = resolve_checkpoint_file(
            resolve_resume_path(args.resume, args.checkpoint_root))
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
