'''
Inference engine (port of occlusions4d_tpu/evaluate/inference.py): load the
networks from a native checkpoint, encode the input cloud, decode the dense
query grid in chunks, merge per-instance track reruns, attach 1-NN ground-truth
labels and split solid from air by predicted density.

Numerics, InferenceEngine(precision=...), resolved as the JAX engine's
__init__ resolves it (self.precision holds the result):
  'fast'          the decoder's kernel path (models/fused.py) in the bf16
                  compute mode: the interpolation, the shared gather and both
                  attention layers through their bf16 kernels (o4d_*_bf16),
                  the backbone's nn.Linear layers in TF32 on CUDA; the JAX
                  engine's fused_field_apply(compute_dtype=bfloat16). A
                  decoder that supports_fused rejects gets 'f32'.
  'f32', 'highest' the kernel path in f32, the counterpart of the JAX
                  engine's 'highest' fused path. The port has no counterpart
                  of JAX's 'f32' (XLA's default-precision dots, one bf16 pass
                  on a TPU), so both names run this path.
  'auto'          'f32': JAX resolves 'auto' to 'f32' off a TPU, and the
                  anchors' committed metrics were computed that way.
fused_decode=True / False overrides precision to 'fast' / 'f32'.
The encoder keeps f32 in every mode: its kNN and FPS take no compute dtype
(the TPU kernels have none), and bf16 features would move FPS's picks. On
CUDA every kNN/FPS goes through its kernel; on the CPU the same code runs the
kernels' plain versions. 'fast' on CUDA runs the bf16 kernels or raises.
'''

import time

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint import from_jax_params, load_native_checkpoint
from ..config import TrainConfig, config_from_dict
from ..models import factory
from ..models.encoder import PointEncoder
from ..models.fused import fused_field_apply, supports_fused
from ..models.implicit import LocalImplicitField
from ..ops import blind_points_numpy
from ..ops.knn import nn1_direct
from ..utils.misc import multi_track_merge

__all__ = ['load_models', 'squash_eval', 'InferenceEngine', 'resolve_precision',
           'dispatch_inference', 'finish_inference', 'perform_inference']


def load_models(checkpoint_path, epoch=-1, device='cuda', logger=None):
    '''
    :param checkpoint_path: native .pkl file or checkpoint directory.
    :param device: where the networks live ('cuda' raises without CUDA).
        The networks are f32 whatever the checkpoint's mixed_precision says,
        as the JAX load_models evaluates in f32.
    :return dict(encoder, decoder, encoder_args, decoder_args, train_config,
        dset_args, data_kind, epoch, device).
    '''
    dev = resolve_device(device)
    print_fn = logger.info if logger is not None else print
    print_fn(f'Loading weights from: {checkpoint_path}')
    ck = load_native_checkpoint(checkpoint_path, epoch)
    meta = ck['meta']
    enc_args = dict(meta['encoder_args'])
    enc_args['fps_random_start'] = False  # deterministic eval.
    dec_args = dict(meta['decoder_args'])
    encoder = PointEncoder(**enc_args)
    decoder = LocalImplicitField(**dec_args)
    encoder.load_state_dict(from_jax_params(ck['params']['encoder'], encoder),
                            strict=True)
    decoder.load_state_dict(from_jax_params(ck['params']['decoder'], decoder),
                            strict=True)
    return dict(encoder=encoder.to(dev).eval(), decoder=decoder.to(dev).eval(),
                encoder_args=enc_args, decoder_args=dec_args,
                train_config=config_from_dict(TrainConfig, meta.get('config', {})),
                dset_args=meta.get('dset_args'), data_kind=meta.get('data_kind'),
                epoch=ck['epoch'], device=dev)


def squash_eval(out, color_mode, predict_segmentation, semantic_classes, track_mode):
    '''Eval-time squash; density becomes a probability. Returns a new tensor.'''
    out = out.clone()
    out[..., 0] = torch.sigmoid(out[..., 0])
    if color_mode == 'rgb':
        out[..., 1:4] = torch.sigmoid(out[..., 1:4])
    elif color_mode == 'rgb_nosigmoid':
        out[..., 1:4] = torch.clamp(out[..., 1:4], 0.0, 1.0)
    elif color_mode == 'hsv':
        out[..., 1:13] = torch.sigmoid(out[..., 1:13])
        out[..., 13:15] = torch.clamp(out[..., 13:15], 0.0, 1.0)
    elif color_mode == 'bins':
        out[..., 1:10] = torch.sigmoid(out[..., 1:10])
    if predict_segmentation:
        out[..., -semantic_classes:] = torch.sigmoid(out[..., -semantic_classes:])
    if track_mode != 'none':
        t_idx = factory.track_idx(color_mode)
        out[..., t_idx] = torch.sigmoid(out[..., t_idx])
    return out


def _to_device(a, device):
    # Copy host arrays: torch.from_numpy would alias the caller's buffer.
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.tensor(np.array(a, dtype=np.float32, copy=True), device=device)


def resolve_precision(decoder, precision='auto', fused_decode=None):
    '''The engine's numerics mode, as the JAX engine resolves it off a TPU:
    fused_decode overrides, 'auto' is 'f32', and 'fast' on a decoder outside
    the fused path is 'f32'. :return 'fast', 'f32' or 'highest'.'''
    if fused_decode is not None:
        precision = 'fast' if fused_decode else 'f32'
    if precision == 'auto':
        precision = 'f32'
    if precision == 'fast' and not supports_fused(decoder):
        precision = 'f32'
    if precision not in ('fast', 'f32', 'highest'):
        raise ValueError(f'precision must be auto, fast, f32 or highest, got {precision!r}')
    return precision


class InferenceEngine:
    '''Encode/decode closures over loaded networks; reuse across frames and
    track reruns. precision / fused_decode: the module docstring.'''

    def __init__(self, loaded, color_mode, predict_segmentation, semantic_classes,
                 track_mode='none', implicit_batch_size=65536, precision='auto',
                 fused_decode=None, query_parallel=-1):
        # The engine runs on one device: query_parallel -1 (all devices) and
        # 1 mean that; sharding the queries over several is not ported
        # (ROADMAP.md, Queue 1 item 6).
        if query_parallel not in (-1, 1):
            raise NotImplementedError(
                f'query_parallel={query_parallel}: the port evaluates on one device '
                '(-1 or 1); query-sharded eval is not ported (ROADMAP.md, Queue 1 '
                'item 6)')
        self.encoder = loaded['encoder']
        self.decoder = loaded['decoder']
        self.precision = resolve_precision(self.decoder, precision, fused_decode)
        self.device = loaded['device']
        self.color_mode = color_mode
        self.predict_segmentation = predict_segmentation
        self.semantic_classes = semantic_classes
        self.track_mode = track_mode
        self.chunk = int(implicit_batch_size)

    @torch.no_grad()
    def encode(self, pcl_input):
        '''pcl_input (N, 8) or (1, N, 8) -> (abstract (1, M, 3+E), global (1, D)).'''
        x = _to_device(pcl_input, self.device)
        if x.dim() == 2:
            x = x[None]
        return self.encoder(x)

    @torch.no_grad()
    def _decode(self, q, abstract, fg):
        # Configurations outside the fused path have no decoder kernel in the
        # JAX package either; they run the module path there and here.
        if supports_fused(self.decoder):
            dtype = torch.bfloat16 if self.precision == 'fast' else torch.float32
            out, _ = fused_field_apply(self.decoder, q, abstract, fg, compute_dtype=dtype)
        else:
            out, _ = self.decoder(q, abstract, fg)
        return squash_eval(out, self.color_mode, self.predict_segmentation,
                           self.semantic_classes, self.track_mode)

    @torch.no_grad()
    def decode_all(self, points_query, abstract, fg, fetch=True):
        '''
        Stream the queries through chunks of implicit_batch_size.
        :param points_query (P, 4) numpy array or tensor.
        :param fetch (bool): return numpy (True) or a device tensor (False).
        :return (P, C) squashed outputs.
        '''
        q = _to_device(points_query, self.device)
        out = torch.cat([self._decode(q[None, c0:c0 + self.chunk], abstract, fg)[0]
                         for c0 in range(0, q.shape[0], self.chunk)], 0)
        return out.cpu().numpy() if fetch else out


def dispatch_inference(pcl_input, pcl_input_sem, engine, min_z, cube_bounds,
                       color_mode, time_idx, sample_implicit=True, num_sample=16384,
                       point_sample_mode='random', track_mode='none', data_kind='',
                       cube_mode=4, rng=None):
    '''
    Device stage of one frame: track-rerun set, blind query generation, and the
    encode/decode of every rerun, returning device tensors. Pair with
    finish_inference. sample_implicit must be True (blind queries), as in the
    JAX engine.
    '''
    assert sample_implicit
    input_inst_idx = 0 if data_kind == 'greater' else 1
    if track_mode in ('none', 'one'):
        track_instance_ids = [-1]
    else:
        sem = np.asarray(pcl_input_sem)
        if data_kind == 'carla':
            # CARLA tracking targets are its vehicle/pedestrian classes.
            sem = sem[np.isin(sem[..., 2], (4, 10))]
        ids, counts = np.unique(sem[..., input_inst_idx], return_counts=True)
        track_instance_ids = [int(i) for i, c in zip(ids, counts)
                              if i >= 0 and c >= 16]

    points_query = blind_points_numpy(num_sample, min_z, cube_bounds, time_idx,
                                      data_kind, cube_mode, point_sample_mode,
                                      rng=rng)
    all_abstract, all_global, all_out = [], [], []
    pcl_input = np.array(pcl_input, np.float32)
    t0 = time.time()
    for mark_inst_id in track_instance_ids:
        pcl_marked = pcl_input
        if mark_inst_id >= 0:
            mask = pcl_input_sem[..., input_inst_idx] == mark_inst_id
            pcl_marked = pcl_input.copy()
            pcl_marked[..., -1] = mask.astype(np.float32)
        abstract, fg = engine.encode(pcl_marked)
        out = engine.decode_all(points_query, abstract, fg, fetch=False)
        all_abstract.append(abstract)
        all_global.append(fg)
        all_out.append(out)
    return dict(track_instance_ids=track_instance_ids, all_abstract=all_abstract,
                all_global=all_global, all_out=all_out, points_query=points_query, color_mode=color_mode,
                dispatch_s=time.time() - t0)


def nn1(query, keys, device):
    '''Exact 1-NN (Euclidean) of query rows among key rows for the
    ground-truth labels: ops.knn.nn1_direct, the per-pair differences and
    lowest-index ties of the JAX engine's nn1_host (a kernel on CUDA).
    :return (dists (N,) f32, idx (N,) int64).'''
    q = _to_device(np.asarray(query)[:, :3], device)
    k = _to_device(np.asarray(keys)[:, :3], device)
    d, idx = nn1_direct(q, k)
    return d.cpu().numpy(), idx.long().cpu().numpy()


def finish_inference(pending, pcl_target_frame, engine, predict_segmentation=False,
                     point_occupancy_radius=0.2, semantic_classes=13,
                     density_threshold=0.5, compress_air=False, store_activations=False):
    '''
    Host stage of one frame: fetch, merge track reruns, 1-NN GT labels,
    density-threshold split, compress_air.
    :param store_activations: the decoder's penultimate activations are not
        ported; True raises.
    :return dict with output_solid, output_air, pcl_abstract, features_global,
        implicit_output, points_query, gt_solid?, gt_air?, phase_s.
    '''
    if store_activations:
        raise NotImplementedError('store_activations (the decoder\'s penultimate '
                                  'activations) is not ported (ROADMAP.md, Queue 1 '
                                  'item 8)')
    gt_available = pcl_target_frame is not None
    output_track_idx = factory.track_idx(pending['color_mode'])
    track_instance_ids = pending['track_instance_ids']
    points_query = pending['points_query']

    phase_s = {}
    t0 = time.time()
    all_abstract = [a[0].cpu().numpy() for a in pending['all_abstract']]
    all_global = [g[0].cpu().numpy() for g in pending['all_global']]
    all_out = [o.cpu().numpy() for o in pending['all_out']]
    phase_s['d2h_fetch'] = time.time() - t0
    phase_s['device_infer'] = pending['dispatch_s'] + phase_s['d2h_fetch']
    phase_s['track_reruns'] = len(track_instance_ids)
    t0 = time.time()
    pcl_abstract, features_global, implicit_output = multi_track_merge(
        track_instance_ids, all_abstract, all_global, all_out, output_track_idx)
    phase_s['track_merge'] = time.time() - t0
    t0 = time.time()
    mark_is_instance_id = not (len(track_instance_ids) == 1
                               and track_instance_ids[0] == -1)
    result = dict(pcl_abstract=pcl_abstract, features_global=features_global,
                  implicit_output=implicit_output, points_query=points_query,
                  mark_is_instance_id=mark_is_instance_id)

    if gt_available:
        d, nn_idx = nn1(points_query, pcl_target_frame, engine.device)
        target_labels = (d < point_occupancy_radius).astype(np.int64)
        points_nngt = np.concatenate([target_labels[:, None],
                                      pcl_target_frame[nn_idx]], axis=-1)
    phase_s['gt_nn1'] = time.time() - t0
    t0 = time.time()

    points_io = np.concatenate([points_query, implicit_output], axis=-1)
    solid_sel = points_io[:, 4] >= density_threshold
    solid_points = points_io[solid_sel]
    air_points = points_io[~solid_sel]
    if compress_air:
        if predict_segmentation:
            air_segm = air_points[:, -semantic_classes:].argmax(axis=-1)
        else:
            air_segm = -np.ones(air_points.shape[0])
        air_points = np.concatenate(
            [air_points[:, :3], air_points[:, 4:5], air_segm[:, None]], axis=-1)
    phase_s['host_post'] = time.time() - t0
    result['phase_s'] = phase_s
    result['output_solid'] = solid_points
    result['output_air'] = air_points
    if gt_available:
        result['gt_solid'] = points_nngt[solid_sel]
        gt_air = points_nngt[~solid_sel]
        if compress_air:
            gt_air = np.concatenate([gt_air[:, :1], gt_air[:, 4:5]], axis=-1)
        result['gt_air'] = gt_air
        result['nn_solid'] = (d[solid_sel], nn_idx[solid_sel])
        result['nn_air_d'] = d[~solid_sel]
    return result


def perform_inference(pcl_input, pcl_input_sem, pcl_target_frame, engine, min_z,
                      cube_bounds, color_mode, time_idx, num_sample=16384,
                      point_sample_mode='random', predict_segmentation=False,
                      track_mode='none', point_occupancy_radius=0.2,
                      semantic_classes=13, density_threshold=0.5, data_kind='',
                      cube_mode=4, compress_air=False, rng=None):
    '''
    One frame of test-time prediction: dispatch_inference + finish_inference.
    :param pcl_input (N, 8) numpy: (x, y, z, R, G, B, t, mark_track).
    :param pcl_input_sem (N, 1-3) numpy or None.
    :param pcl_target_frame (M, 9-11) numpy or None (GT for 1-NN labels).
    '''
    pending = dispatch_inference(
        pcl_input, pcl_input_sem, engine, min_z, cube_bounds, color_mode,
        time_idx, num_sample=num_sample,
        point_sample_mode=point_sample_mode, track_mode=track_mode,
        data_kind=data_kind, cube_mode=cube_mode, rng=rng)
    return finish_inference(
        pending, pcl_target_frame, engine, predict_segmentation=predict_segmentation,
        point_occupancy_radius=point_occupancy_radius,
        semantic_classes=semantic_classes, density_threshold=density_threshold,
        compress_air=compress_air)
