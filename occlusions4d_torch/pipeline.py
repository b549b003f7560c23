'''
Training forward (port of occlusions4d_tpu/pipeline.py): encode the input
video, then per predicted frame: guided query sampling -> field evaluation
-> train-time color squash; the masked losses over all frames.

The sampled queries and targets are data, not functions of the weights: they
are detached before the decoder, as the JAX pipeline stop-gradients them.
The decoder runs fused_field_apply (kernels on CUDA, plain versions on the
CPU) when the configuration is covered, in the compute dtype of
fused_decoder_dtype (resolve_decoder_dtype), else the module path in the
decoder's own dtype (bf16 under mixed_precision, as the JAX pipeline's
module path). Either way the frame's output reaches the squash and the
losses in f32. Randomness (FPS starts, other-frame choice, sampling) comes
from one torch.Generator.
'''

import dataclasses

import torch

from .losses import LossConfig, per_example_losses, total_loss
from .models.fused import fused_field_apply, supports_fused
from .sampler import GuidedPointSampler, SamplerConfig

__all__ = ['PipelineConfig', 'TrainPipeline', 'resolve_decoder_dtype', 'squash_colors']

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
    compute dtype (resolve_decoder_dtype); the module path, taken when the
    configuration is not covered, computes in the decoder's dtype.'''

    def __init__(self, encoder, decoder, sampler_cfg: SamplerConfig,
                 cfg: PipelineConfig, fused_decoder_dtype='auto'):
        self.encoder = encoder
        self.decoder = decoder
        self.sampler = GuidedPointSampler(sampler_cfg)
        self.cfg = cfg
        self.fused_decoder = supports_fused(decoder)
        self.decoder_dtype = resolve_decoder_dtype(fused_decoder_dtype)

    def _decode_frame(self, points_query, abstract, features_global):
        if self.fused_decoder:
            return fused_field_apply(self.decoder, points_query, abstract,
                                     features_global,
                                     compute_dtype=self.decoder_dtype)[0]
        return self.decoder(points_query, abstract, features_global)[0].to(torch.float32)

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
        :return (losses dict, aux dict).'''
        cfg = self.cfg
        output = torch.stack([
            squash_colors(self._decode_frame(f['points_query'], abstract,
                                             features_global), cfg.color_mode)
            for f in frames], 1)                                # (B, T, S + A, C).
        target = torch.stack([f['implicit_target'] for f in frames], 1)
        ok_bt = torch.stack([f['ok'] for f in frames], 1)       # (B, T).
        losses = per_example_losses(output, target, cfg.loss_config, frame_weight=ok_bt)
        aux = dict(abstract=abstract, features_global=features_global,
                   implicit_output=output, implicit_target=target,
                   solid_sbs=torch.stack([f['solid_sbs'] for f in frames], 1).mean((0, 1)),
                   air_sbs=torch.stack([f['air_sbs'] for f in frames], 1).mean((0, 1)),
                   sample_ok=ok_bt.all(), sample_ok_frac=ok_bt.to(torch.float32).mean())
        return losses, aux

    def forward(self, batch, generator, mark=None):
        '''
        :param batch: dict of tensors on one device: pcl_input (B, N, 8);
            pcl_target (B, T, M, E); pcl_target_valid (B, T, M) bool;
            valo_ids (B, R) int; num_valo_ids (B,) int.
        :param generator: torch.Generator on that device.
        :param mark: optional phase-timing callback, called with 'encoder'
            and 'sampler' once each part has been enqueued, and with
            'decoder_backward' from a gradient hook on the abstract cloud,
            when a later backward has passed through the decoder.
        :return (losses dict, aux dict).
        '''
        abstract, feats_global = self.encoder(batch['pcl_input'], generator=generator)
        if mark is not None:
            mark('encoder')
            if abstract.requires_grad:
                abstract.register_hook(lambda g: mark('decoder_backward'))
        frames = self.sample_frames(batch, generator)
        if mark is not None:
            mark('sampler')
        return self.decode_frames(frames, abstract, feats_global)

    def loss(self, batch, generator, mark=None):
        '''Scalar objective plus (losses, aux). `mark` as in forward, and
        called with 'decoder_forward' once the losses have been enqueued.'''
        losses, aux = self.forward(batch, generator, mark)
        loss = total_loss(losses, self.cfg.loss_config)
        if mark is not None:
            mark('decoder_forward')
        return loss, (losses, aux)
