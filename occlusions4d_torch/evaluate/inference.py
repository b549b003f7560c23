'''
Inference engine (port of occlusions4d_tpu/evaluate/inference.py): load the
networks from a native or a reference (.pth) checkpoint, encode the input
cloud, decode the dense query grid in chunks, merge per-instance track
reruns, attach 1-NN ground-truth labels and split solid from air by
predicted density.

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
store_activations=True keeps the decoder's penultimate activations (the
input of its output layer; the fused path's penult in every precision, the
module path's second output) as float16 beside the outputs: decode_all
returns both, and finish_inference keeps the predicted-solid rows
(result['penult_solid']), for offline analysis (--store_activations).
The encoder keeps f32 in every mode: its kNN and FPS take no compute dtype
(the TPU kernels have none), and bf16 features would move FPS's picks. On
CUDA every kNN/FPS goes through its kernel; on the CPU the same code runs the
kernels' plain versions. 'fast' on CUDA runs the bf16 kernels or raises.
'''

import copy
import time

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint import (from_jax_params, load_native_checkpoint, load_reference_checkpoint,
                          resolve_checkpoint_file)
from ..config import TrainConfig, config_from_dict
from ..models import factory
from ..models.encoder import PointEncoder
from ..models.fused import fused_field_apply, supports_fused
from ..models.implicit import LocalImplicitField
from ..ops import blind_points_numpy
from ..ops.knn import nn1_direct
from ..parallel import local_devices
from ..utils import profiling
from ..utils.misc import multi_track_merge

__all__ = ['load_models', 'squash_eval', 'InferenceEngine', 'resolve_precision',
           'dispatch_inference', 'finish_inference', 'perform_inference']


def _strip_mixed_precision(d):
    d = dict(d)
    d.pop('mixed_precision', None)
    return d


def load_models(checkpoint_path, epoch=-1, device='cuda', logger=None):
    '''
    :param checkpoint_path: a native .pkl, a reference .pth, or a checkpoint
        directory (checkpoint.resolve_checkpoint_file: its pkl epochs, else
        model_{epoch}.pth / checkpoint.pth).
    :param device: where the networks live ('cuda' raises without CUDA).
        The networks are f32 whatever the checkpoint's mixed_precision says,
        as the JAX load_models evaluates in f32.
    :return dict(encoder, decoder, encoder_args, decoder_args, train_config,
        dset_args, data_kind, epoch, device). A .pth gives the JAX
        load_models' fields for it: the constructor args without
        mixed_precision, train_config from its args, data_kind None.
    '''
    dev = resolve_device(device)
    print_fn = logger.info if logger is not None else print
    path = resolve_checkpoint_file(checkpoint_path, epoch)
    print_fn(f'Loading weights from: {path}')
    if path.endswith('.pth'):
        ref = load_reference_checkpoint(path)
        enc_args = _strip_mixed_precision(ref['pcl_args'])
        dec_args = _strip_mixed_precision(ref['implicit_args'])
        params = dict(encoder=ref['encoder_variables'], decoder=ref['decoder_variables'])
        train_args = ref['train_args']
        train_cfg = (config_from_dict(TrainConfig, vars(train_args))
                     if hasattr(train_args, '__dict__') else TrainConfig())
        dset_args, data_kind, ck_epoch = ref['dset_args'], None, ref['epoch']
    else:
        ck = load_native_checkpoint(path)
        meta = ck['meta']
        enc_args = dict(meta['encoder_args'])
        dec_args = dict(meta['decoder_args'])
        params = ck['params']
        train_cfg = config_from_dict(TrainConfig, meta.get('config', {}))
        dset_args, data_kind, ck_epoch = meta.get('dset_args'), meta.get('data_kind'), ck['epoch']
    enc_args['fps_random_start'] = False  # deterministic eval.
    encoder = PointEncoder(**enc_args)
    decoder = LocalImplicitField(**dec_args)
    encoder.load_state_dict(from_jax_params(params['encoder'], encoder), strict=True)
    decoder.load_state_dict(from_jax_params(params['decoder'], decoder), strict=True)
    return dict(encoder=encoder.to(dev).eval(), decoder=decoder.to(dev).eval(),
                encoder_args=enc_args, decoder_args=dec_args, train_config=train_cfg,
                dset_args=dset_args, data_kind=data_kind, epoch=ck_epoch, device=dev)


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
    track reruns. precision / fused_decode: the module docstring.

    Query sharding (the JAX engine's mesh over query_parallel devices):
    query_parallel n decodes on parallel.local_devices(n) of the networks'
    device type (-1: every card; on the CPU, n replicas), or on `devices`
    where given (e.g. ['cuda:0', 'cuda:0']). The networks' device comes
    first; every other entry gets a replica of the decoder. The chunk is
    rounded down to a multiple of the device count (at least one query
    each), and each chunk's queries are split in contiguous slices, one a
    device, launched device after device (so that cards overlap), the
    outputs (and the activations) joined on the first device in query
    order. Every kernel wrapper launches on its tensors' device. The encoder
    runs once, on the first device; its abstract cloud and global feature
    are copied to the others.'''

    def __init__(self, loaded, color_mode, predict_segmentation, semantic_classes,
                 track_mode='none', implicit_batch_size=65536, precision='auto',
                 fused_decode=None, query_parallel=-1, devices=None,
                 store_activations=False):
        self.store_activations = store_activations
        self.encoder = loaded['encoder']
        self.decoder = loaded['decoder']
        self.precision = resolve_precision(self.decoder, precision, fused_decode)
        self.device = loaded['device']
        self.color_mode = color_mode
        self.predict_segmentation = predict_segmentation
        self.semantic_classes = semantic_classes
        self.track_mode = track_mode
        if devices is None:
            devices = local_devices(query_parallel, self.device.type)
        self.devices = [self.device] + [torch.device(d) for d in devices[1:]]
        self.decoders = [self.decoder] + [copy.deepcopy(self.decoder).to(d)
                                          for d in self.devices[1:]]
        n_dev = len(self.devices)
        self.chunk = max(int(implicit_batch_size) // n_dev, 1) * n_dev

    @torch.no_grad()
    def encode(self, pcl_input):
        '''pcl_input (N, 8) or (1, N, 8) -> (abstract (1, M, 3+E), global (1, D)),
        in the tiled span scene.encode.'''
        with profiling.span('scene.encode', tile=True):
            x = _to_device(pcl_input, self.device)
            if x.dim() == 2:
                x = x[None]
            return self.encoder(x)

    @torch.no_grad()
    def _decode(self, q, abstract, fg, decoder=None):
        '''(squashed outputs, float16 penultimate activations or None).'''
        # Configurations outside the fused path have no decoder kernel in the
        # JAX package either; they run the module path there and here.
        decoder = self.decoder if decoder is None else decoder
        if supports_fused(decoder):
            dtype = torch.bfloat16 if self.precision == 'fast' else torch.float32
            out, penult = fused_field_apply(decoder, q, abstract, fg, compute_dtype=dtype)
        else:
            out, penult = decoder(q, abstract, fg)
        out = squash_eval(out, self.color_mode, self.predict_segmentation,
                          self.semantic_classes, self.track_mode)
        return out, (penult.to(torch.float16) if self.store_activations else None)

    @torch.no_grad()
    def decode_all(self, points_query, abstract, fg, fetch=True):
        '''
        Stream the queries through chunks of implicit_batch_size.
        :param points_query (P, 4) numpy array or tensor.
        :param fetch (bool): return numpy (True) or a device tensor (False).
        :return (P, C) squashed outputs; with store_activations the pair
            (outputs, (P, d_hidden) float16 penultimate activations).
        In the tiled span scene.decode, each chunk a tiled scene.decode_chunk
        in it, then the fetch in scene.fetch; counters scene.queries_decoded
        and scene.decode_chunks.
        '''
        with profiling.span('scene.decode', tile=True):
            q = _to_device(points_query, self.device)
            # Each device's copy of the encoding (the first device's are the
            # inputs themselves); with one device a chunk is one slice.
            enc = [(abstract, fg)] + [(abstract.to(d), fg.to(d)) for d in self.devices[1:]]
            part = self.chunk // len(self.devices)
            outs, penults = [], []
            for c0 in range(0, q.shape[0], self.chunk):
                with profiling.span('scene.decode_chunk', tile=True):
                    for i, (dev, dec) in enumerate(zip(self.devices, self.decoders)):
                        lo = c0 + i * part
                        hi = min(lo + part, c0 + self.chunk, q.shape[0])
                        if lo >= hi:     # the tail chunk's empty slices.
                            break
                        qs = q[None, lo:hi].to(dev, non_blocking=True)
                        out, penult = self._decode(qs, *enc[i], decoder=dec)
                        outs.append(out[0])
                        if penult is not None:
                            penults.append(penult[0])
                profiling.count('scene.decode_chunks')
            res = [torch.cat([o.to(self.device) for o in outs], 0)]
            if self.store_activations:
                res.append(torch.cat([p.to(self.device) for p in penults], 0))
        profiling.count('scene.queries_decoded', q.shape[0])
        if fetch:
            with profiling.span('scene.fetch', tile=True):
                res = [r.cpu().numpy() for r in res]
        return tuple(res) if self.store_activations else res[0]


def dispatch_inference(pcl_input, pcl_input_sem, engine, min_z, cube_bounds,
                       color_mode, time_idx, sample_implicit=True, num_sample=16384,
                       point_sample_mode='random', track_mode='none', data_kind='',
                       cube_mode=4, rng=None):
    '''
    Device stage of one frame: track-rerun set, blind query generation, and the
    encode/decode of every rerun, returning device tensors. Pair with
    finish_inference. sample_implicit must be True (blind queries), as in the
    JAX engine.
    The frame is an item of utils/profiling.py: a root span scene, ended by
    finish_inference (or by the eval loop after the frame's metrics), tiled
    by scene.grid (blind_points_numpy), scene.encode and scene.decode (each
    rerun's; the queries' copy in decode_all), scene.fetch, scene.post and
    scene.gt_nn1; counter scene.track_reruns.
    '''
    assert sample_implicit
    root = profiling.begin('scene', root=True)
    with profiling.within(root):
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
        profiling.count('scene.track_reruns', len(track_instance_ids))

        with profiling.span('scene.grid', tile=True):
            points_query = blind_points_numpy(num_sample, min_z, cube_bounds, time_idx,
                                              data_kind, cube_mode, point_sample_mode,
                                              rng=rng)
        all_abstract, all_global, all_out = [], [], []
        penult = None
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
            if engine.store_activations:
                out, run_penult = out
                if penult is None:     # the first run's (the unmarked one without reruns).
                    penult = run_penult
            all_abstract.append(abstract)
            all_global.append(fg)
            all_out.append(out)
        return dict(track_instance_ids=track_instance_ids, all_abstract=all_abstract,
                    all_global=all_global, all_out=all_out, penult=penult,
                    points_query=points_query, color_mode=color_mode,
                    dispatch_s=time.time() - t0, span=root)


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
                     density_threshold=0.5, compress_air=False, store_activations=False,
                     end_root=True):
    '''
    Host stage of one frame: fetch, merge track reruns, 1-NN GT labels,
    density-threshold split, compress_air; the spans scene.fetch, scene.post
    (the merge, then the split), scene.gt_nn1, tiled in dispatch_inference's
    root span, which it ends unless end_root is false (the eval loop ends it
    after the frame's metrics and export: test_driver._FramePost.frame).
    :param store_activations: with an engine that kept them, the decoder's
        penultimate activations of the predicted-solid queries (float16) in
        result['penult_solid'].
    :return dict with output_solid, output_air, pcl_abstract, features_global,
        implicit_output, points_query, gt_solid?, gt_air?, penult_solid?,
        phase_s.
    '''
    span = profiling.span
    root = pending.get('span')
    with profiling.within(root):
        gt_available = pcl_target_frame is not None
        output_track_idx = factory.track_idx(pending['color_mode'])
        track_instance_ids = pending['track_instance_ids']
        points_query = pending['points_query']

        phase_s = {}
        t0 = time.time()
        with span('scene.fetch', tile=True):
            all_abstract = [a[0].cpu().numpy() for a in pending['all_abstract']]
            all_global = [g[0].cpu().numpy() for g in pending['all_global']]
            all_out = [o.cpu().numpy() for o in pending['all_out']]
            penult = pending.get('penult')
            if store_activations and penult is not None:
                penult = penult.cpu().numpy()
        phase_s['d2h_fetch'] = time.time() - t0
        phase_s['device_infer'] = pending['dispatch_s'] + phase_s['d2h_fetch']
        phase_s['track_reruns'] = len(track_instance_ids)
        t0 = time.time()
        with span('scene.post', tile=True):
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
            with span('scene.gt_nn1', tile=True):
                d, nn_idx = nn1(points_query, pcl_target_frame, engine.device)
                target_labels = (d < point_occupancy_radius).astype(np.int64)
                points_nngt = np.concatenate([target_labels[:, None],
                                              pcl_target_frame[nn_idx]], axis=-1)
        phase_s['gt_nn1'] = time.time() - t0
        t0 = time.time()

        with span('scene.post', tile=True):
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
        if store_activations and penult is not None:
            result['penult_solid'] = penult[solid_sel]
        if gt_available:
            result['gt_solid'] = points_nngt[solid_sel]
            gt_air = points_nngt[~solid_sel]
            if compress_air:
                gt_air = np.concatenate([gt_air[:, :1], gt_air[:, 4:5]], axis=-1)
            result['gt_air'] = gt_air
            result['nn_solid'] = (d[solid_sel], nn_idx[solid_sel])
            result['nn_air_d'] = d[~solid_sel]
    if end_root:
        profiling.end(root)
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
