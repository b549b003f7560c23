'''
Training forward (port of occlusions4d_tpu/pipeline.py): encode the input
video, then per predicted frame: guided query sampling -> field evaluation
-> train-time color squash; the masked losses over all frames.

The sampled queries and targets are data, not functions of the weights: they
are detached before the decoder, as the JAX pipeline stop-gradients them.
fused_decoder ('auto' | 'on' | 'off', the JAX pipeline's): 'auto' and 'on'
run fused_field_apply (kernels on CUDA, plain versions on the CPU) when the
configuration is covered (supports_fused), in the compute dtype of
fused_decoder_dtype (resolve_decoder_dtype); 'off', and a configuration the
fused path does not cover, run the module path, self.decoder(...), in the
decoder's own dtype (bf16 under mixed_precision, as the JAX pipeline's
module path). With remat (the default) the module path recomputes each
frame's field in the backward (torch.utils.checkpoint, JAX's
jax.checkpoint): a frame's (N, K, D) attention intermediates are kept for
one frame at a time, not for every frame; the fused path keeps no outer
remat, its backward kernels recompute per tile. Either way the frame's
output reaches the squash and the losses in f32. Randomness (FPS starts,
other-frame choice, sampling) comes from one torch.Generator, drawn before
any decoder call, so a recomputed frame draws nothing.

debug_checks (the train driver's --check_numerics): named probes at the
tensor boundaries of the JAX pipeline's, in its order: pcl_input,
encoder_abstract, encoder_global after the encoder, decoder_output_frame{t}
after each frame's squash, loss_{k} for each loss in name order. The first
tensor that holds a NaN or an Inf raises RuntimeError('NaN/Inf detected in
<name>'); each probe waits for the card (a copy of one flag to the host).

Batch norm (pt_norm_type 'batch'): the encoder runs in train mode, so every
forward (the train step's, and the val_aug and viz steps') normalises with
the batch's statistics, as the JAX pipeline's encoder.apply(..., train=True)
does. The running statistics' update each forward computes is taken into
aux['batch_stats'] (models/layers.py::take_batch_stats); only the train
step commits it (train.py), after the optimizer step.

Data parallel (group, a parallel.Group): each rank runs its rows of the
global batch. Its losses are its shares of the global weighted means
(losses.py), which its backward differentiates; aux['global_losses'] holds
the global means, and sample_ok, sample_ok_frac, solid_sbs and air_sbs are
the global batch's, all from one all-reduce. Batch norm takes the group's
statistics (models/layers.py::set_norm_group, which the Trainer calls).
'''

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from .losses import LossConfig, per_example_losses, total_loss
from .models.fused import fused_field_apply, supports_fused
from .models.layers import take_batch_stats
from .parallel import all_reduce_sum
from .sampler import GuidedPointSampler, SamplerConfig
from .utils import profiling

__all__ = ['PipelineConfig', 'TrainPipeline', 'resolve_decoder_dtype', 'squash_colors',
           'numerics_probe']

_DECODER_DTYPES = {'bf16': torch.bfloat16, 'f32': torch.float32,
                   'auto': torch.float32}


def resolve_decoder_dtype(fused_decoder_dtype):
    '''The fused decoder's compute dtype of a TrainConfig.fused_decoder_dtype
    (occlusions4d_tpu/pipeline.py:110-116): 'bf16' and 'f32' as named;
    'auto' is bf16 only on a TPU there, so f32 here, on the card as on the
    CPU.'''
    if fused_decoder_dtype not in _DECODER_DTYPES:
        raise ValueError(f"fused_decoder_dtype must be 'auto', 'bf16' or 'f32', got "
                         f'{fused_decoder_dtype!r}')
    return _DECODER_DTYPES[fused_decoder_dtype]


def squash_colors(out, color_mode):
    '''Train-time squash; density stays a logit. rgb gets a sigmoid,
    rgb_nosigmoid and hsv's sat/val a clamp to [0, 1], bins stays logits.'''
    if color_mode == 'rgb':
        return torch.cat([out[..., :1], torch.sigmoid(out[..., 1:4]), out[..., 4:]], -1)
    if color_mode == 'rgb_nosigmoid':
        return torch.cat([out[..., :1], torch.clamp(out[..., 1:4], 0.0, 1.0),
                          out[..., 4:]], -1)
    if color_mode == 'hsv':
        return torch.cat([out[..., :13], torch.clamp(out[..., 13:15], 0.0, 1.0),
                          out[..., 15:]], -1)
    if color_mode == 'bins':
        return out
    raise ValueError(color_mode)


def numerics_probe(name, x):
    '''Raise RuntimeError naming `name` where x holds a NaN or an Inf.'''
    if not bool(torch.isfinite(x.detach()).all()):
        raise RuntimeError('NaN/Inf detected in ' + name)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    color_mode: str = 'rgb'
    semantic_classes: int = 13
    past_frames: int = 2
    future_frames: int = 0
    density_lw: float = 1.0
    color_lw: float = 0.0
    segmentation_lw: float = 0.0
    tracking_lw: float = 0.0

    @property
    def num_frames(self):
        return self.past_frames + self.future_frames

    @property
    def loss_config(self):
        return LossConfig(color_mode=self.color_mode,
                          semantic_classes=self.semantic_classes,
                          density_lw=self.density_lw, color_lw=self.color_lw,
                          segmentation_lw=self.segmentation_lw,
                          tracking_lw=self.tracking_lw)


class TrainPipeline:
    '''The training forward over torch modules (their parameters are the
    state). Construct once; call loss() inside the train step.
    fused_decoder_dtype ('auto' | 'bf16' | 'f32'): the fused decoder's
    compute dtype (resolve_decoder_dtype); the module path computes in the
    decoder's dtype. group: the data-parallel group whose ranks hold the
    rest of the batch, or None. fused_decoder ('auto' | 'on' | 'off'),
    remat and debug_checks: the module docstring.'''

    def __init__(self, encoder, decoder, sampler_cfg: SamplerConfig,
                 cfg: PipelineConfig, fused_decoder_dtype='auto', group=None,
                 fused_decoder='auto', remat=True, debug_checks=False):
        if fused_decoder not in ('auto', 'on', 'off'):
            raise ValueError(f"fused_decoder must be 'auto', 'on' or 'off', got "
                             f'{fused_decoder!r}')
        self.group = group
        self.encoder = encoder
        self.decoder = decoder
        self.sampler = GuidedPointSampler(sampler_cfg)
        self.cfg = cfg
        self.fused_decoder = fused_decoder != 'off' and supports_fused(decoder)
        self.decoder_dtype = resolve_decoder_dtype(fused_decoder_dtype)
        self.remat = remat
        self.debug_checks = debug_checks

    def _module_frame(self, points_query, abstract, features_global):
        return self.decoder(points_query, abstract, features_global)[0].to(torch.float32)

    def _decode_frame(self, points_query, abstract, features_global):
        if self.fused_decoder:
            return fused_field_apply(self.decoder, points_query, abstract,
                                     features_global,
                                     compute_dtype=self.decoder_dtype)[0]
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._module_frame, points_query, abstract, features_global,
                              use_reentrant=False, preserve_rng_state=False)
        return self._module_frame(points_query, abstract, features_global)

    def _probe(self, name, x):
        if self.debug_checks:
            numerics_probe(name, x)

    def sample_frames(self, batch, generator):
        '''The guided queries and targets of every frame, as data (detached).
        :return list over frames of dict(points_query (B, S + A, 4),
            implicit_target (B, S + A, 6), solid_sbs, air_sbs, ok (B,)).'''
        T = self.cfg.num_frames
        pcl_target = batch['pcl_target']
        tgt_valid = batch['pcl_target_valid']
        B, T_data = pcl_target.shape[:2]
        if T_data != T:
            raise ValueError(f'pcl_target holds {T_data} frames, the config {T}')
        dev = pcl_target.device
        ex = torch.arange(B, device=dev)
        frames = []
        for t in range(T):
            # A random other frame per example (the dynamic-region source).
            if T > 1:
                other_t = torch.randint(0, T - 1, (B,), generator=generator, device=dev)
                other_t = torch.where(other_t == t, other_t + 1, other_t)
            else:
                other_t = torch.zeros((B,), dtype=torch.int64, device=dev)
            s = self.sampler.sample_frame(
                generator, pcl_target[:, t], tgt_valid[:, t], pcl_target[ex, other_t],
                tgt_valid[ex, other_t], batch['valo_ids'], batch['num_valo_ids'], t)
            frames.append(dict(
                points_query=torch.cat([s['solid_input'], s['air_input']], 1).detach(),
                implicit_target=torch.cat([s['solid_target'], s['air_target']],
                                          1).detach(),
                solid_sbs=s['solid_sbs'], air_sbs=s['air_sbs'], ok=s['ok']))
        return frames

    def decode_frames(self, frames, abstract, features_global):
        '''Field evaluation, squash and losses over sampled frames.
        :return (losses dict, aux dict): aux holds the JAX pipeline's
            abstract, features_global, points_query (B, T, S + A, 4),
            implicit_output, implicit_target, solid_sbs, air_sbs, sample_ok
            and sample_ok_frac.'''
        cfg = self.cfg
        outputs = []
        for t, f in enumerate(frames):
            out = squash_colors(self._decode_frame(f['points_query'], abstract,
                                                   features_global), cfg.color_mode)
            self._probe(f'decoder_output_frame{t}', out)
            outputs.append(out)
        output = torch.stack(outputs, 1)                        # (B, T, S + A, C).
        target = torch.stack([f['implicit_target'] for f in frames], 1)
        ok_bt = torch.stack([f['ok'] for f in frames], 1)       # (B, T).
        losses = per_example_losses(output, target, cfg.loss_config, frame_weight=ok_bt,
                                    group=self.group)
        for k in sorted(losses):
            self._probe('loss_' + k, losses[k])
        solid_sbs = torch.stack([f['solid_sbs'] for f in frames], 1)
        air_sbs = torch.stack([f['air_sbs'] for f in frames], 1)
        aux = dict(abstract=abstract, features_global=features_global,
                   points_query=torch.stack([f['points_query'] for f in frames], 1),
                   implicit_output=output, implicit_target=target)
        if self.group is None:
            aux.update(solid_sbs=solid_sbs.mean((0, 1)), air_sbs=air_sbs.mean((0, 1)),
                       sample_ok=ok_bt.all(), sample_ok_frac=ok_bt.to(torch.float32).mean())
            return losses, aux
        # The global batch's means, from one all-reduce of the sums and counts.
        names = list(losses)
        ok = ok_bt.to(torch.float32)
        n_s, n_a = solid_sbs.shape[-1], air_sbs.shape[-1]
        packed = all_reduce_sum(torch.cat([
            torch.stack([losses[k].detach().to(torch.float32) for k in names]),
            torch.stack([ok.sum(), torch.full_like(ok.sum(), ok.numel())]),
            solid_sbs.sum((0, 1)), air_sbs.sum((0, 1))]), self.group)
        n_l = len(names)
        n_ok, n_bt = packed[n_l], packed[n_l + 1]
        aux.update(global_losses=dict(zip(names, packed[:n_l].unbind(0))),
                   solid_sbs=packed[n_l + 2:n_l + 2 + n_s] / n_bt,
                   air_sbs=packed[n_l + 2 + n_s:n_l + 2 + n_s + n_a] / n_bt,
                   sample_ok=n_ok == n_bt, sample_ok_frac=n_ok / n_bt)
        return losses, aux

    def forward(self, batch, generator, mark=None, return_intermediate=False):
        '''
        :param batch: dict of tensors on one device: pcl_input (B, N, 8);
            pcl_target (B, T, M, E); pcl_target_valid (B, T, M) bool;
            valo_ids (B, R) int; num_valo_ids (B,) int.
        :param generator: torch.Generator on that device.
        :param mark: optional phase-timing callback, called with 'encoder'
            and 'sampler' once each part has been enqueued, and with
            'decoder_backward' from a gradient hook on the abstract cloud,
            when a later backward has passed through the decoder.
        :param return_intermediate: aux also holds layer_coords, the
            encoder's per-layer positions (else None).
        :return (losses dict, aux dict); aux['total_loss'] is the losses'
            objective (losses.total_loss), aux['batch_stats'] holds the
            encoder's pending running-statistics updates (empty without
            batch norm). The encoder, the sampler and the decoder with the
            losses run in the tiled spans train.encoder, train.sampler and
            train.decoder_fwd (utils/profiling.py).
        '''
        with profiling.span('train.encoder', tile=True):
            abstract, feats_global, *coords = self.encoder(
                batch['pcl_input'], generator=generator,
                return_intermediate=return_intermediate)
            bn_updates = take_batch_stats(self.encoder)
            self._probe('pcl_input', batch['pcl_input'])
            self._probe('encoder_abstract', abstract)
            self._probe('encoder_global', feats_global)
        if mark is not None:
            mark('encoder')
            if abstract.requires_grad:
                abstract.register_hook(lambda g: mark('decoder_backward'))
        with profiling.span('train.sampler', tile=True):
            frames = self.sample_frames(batch, generator)
        if mark is not None:
            mark('sampler')
        with profiling.span('train.decoder_fwd', tile=True):
            losses, aux = self.decode_frames(frames, abstract, feats_global)
            aux['total_loss'] = total_loss(losses, self.cfg.loss_config)
        aux['layer_coords'] = coords[0] if coords else None
        aux['batch_stats'] = bn_updates
        return losses, aux

    def loss(self, batch, generator, mark=None):
        '''Scalar objective plus (losses, aux). `mark` as in forward, and
        called with 'decoder_forward' once the losses have been enqueued.
        With a group the objective is this rank's share of the global one.'''
        losses, aux = self.forward(batch, generator, mark)
        if mark is not None:
            mark('decoder_forward')
        return aux['total_loss'], (losses, aux)
