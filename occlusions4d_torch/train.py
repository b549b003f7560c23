'''
The train step (port of occlusions4d_tpu/train.py:50-174): AdamW with a
piecewise-constant learning rate, global-norm gradient clipping, the skip of
a step whose gradients are not finite and the hard failure on a non-finite
parameter, around the TrainPipeline forward.

The optimizer is written to optax's formulas, so a step moves the weights
as the JAX package's `optax.chain(clip_by_global_norm, masked(adamw))` does:
  * clip: with n = sqrt(sum of every gradient squared), g <- (g / n) * clip
    unless n < clip (no epsilon, unlike torch.nn.utils.clip_grad_norm_);
  * mu <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g^2 + b2 nu;  c <- c + 1;
    u = (mu / (1 - b1^c)) / (sqrt(nu / (1 - b2^c)) + eps) + wd p;
    p <- p + (-lr(c - 1)) u, with b1 0.9, b2 0.999, wd 1e-2 on every
    parameter (batch-norm statistics are buffers, not parameters), eps 1e-8,
    or 1e-4 under mixed_precision (JAX train.py:70);
  * lr(count) = learn_rate x lr_decay for every boundary <= count, the
    boundaries at 2/5, 3/5 and 4/5 of num_epochs x steps_per_epoch.
A step with a non-finite gradient leaves the parameters, the moments and the
count as they were. All of it stays on the device: the step count is a
tensor and the skip is a torch.where, so the update never waits for the host.
The caller reads params_finite once per step (Trainer.step).

The fused decoder computes in cfg.fused_decoder_dtype (pipeline.py:
'auto' is f32 here; 'bf16' runs the decoder's kernels in their bf16 mode,
forward and backward, and its plain products in TF32, models/fused.py).
cfg.mixed_precision builds both networks in bf16 (models/layers.py: bf16
linear layers over f32 parameters; the encoder's fused self-attention in
its bf16 mode with fused_attention='on'), as the JAX Trainer does
(train.py:254), with AdamW's eps 1e-4; the fused decoder then reads the
bf16 encoder's outputs in its own compute dtype. Entry points run on CUDA
unless asked for the CPU; TF32 stays off outside that decoder.
'''

import numpy as np
import torch

from . import resolve_device
from .checkpoint import from_jax_params
from .models.factory import build_models, build_sampler_args
from .pipeline import PipelineConfig, TrainPipeline, resolve_decoder_dtype
from .sampler import SamplerConfig

__all__ = ['AdamW', 'build_optimizer', 'make_train_step', 'Trainer']


class AdamW:
    '''optax.chain(clip_by_global_norm(clip), adamw(schedule, B1, B2, eps,
    WEIGHT_DECAY)) over a list of parameters, updated in place.'''
    B1, B2, WEIGHT_DECAY = 0.9, 0.999, 1e-2

    def __init__(self, params, learn_rate, boundaries, clip, eps=1e-8):
        self.params = list(params)
        self.learn_rate = learn_rate
        self.boundaries = sorted(boundaries.items())   # [(step, scale)].
        self.clip = clip
        self.eps = eps
        dev = self.params[0].device
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32, device=dev)

    def lr(self, count):
        '''Piecewise-constant schedule at a (device) step count.'''
        lr = torch.full((), self.learn_rate, dtype=torch.float32, device=count.device)
        for boundary, scale in self.boundaries:
            lr = torch.where(count < boundary, lr, lr * scale)
        return lr

    @torch.no_grad()
    def update(self, grads, grad_norm, apply):
        '''One step. :param grads: list matching params; grad_norm: their
        global norm; apply: bool tensor, False leaves everything unchanged.'''
        if self.clip > 0:
            # optax's (g / n) * clip, unless n < clip.
            grads = [torch.where(grad_norm < self.clip, g, (g / grad_norm) * self.clip)
                     for g in grads]
        count_inc = self.count + 1
        c = count_inc.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(self.B1, device=c.device), c)
        bc2 = 1.0 - torch.pow(torch.tensor(self.B2, device=c.device), c)
        step = -self.lr(self.count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu_new = (1.0 - self.B1) * g + self.B1 * mu
            nu_new = (1.0 - self.B2) * (g * g) + self.B2 * nu
            u = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + self.eps)
            u = u + self.WEIGHT_DECAY * p
            p.copy_(torch.where(apply, p + step * u, p))
            mu.copy_(torch.where(apply, mu_new, mu))
            nu.copy_(torch.where(apply, nu_new, nu))
        self.count.copy_(torch.where(apply, count_inc, self.count))


def build_optimizer(cfg, steps_per_epoch, params):
    '''AdamW + multistep schedule + global-norm clip of a training config
    (eps 1e-4 under mixed_precision, else 1e-8, as the JAX build_optimizer).
    :param params: the parameters to train.'''
    milestones = [(cfg.num_epochs * 2) // 5, (cfg.num_epochs * 3) // 5,
                  (cfg.num_epochs * 4) // 5]
    boundaries = {m * steps_per_epoch: cfg.lr_decay for m in milestones if m > 0}
    return AdamW(params, cfg.learn_rate, boundaries, cfg.gradient_clip,
                 eps=1e-4 if cfg.mixed_precision else 1e-8)


def make_train_step(pipeline: TrainPipeline, optimizer: AdamW):
    '''
    :return step(batch, generator, mark=None) -> metrics: forward and
        backward through the pipeline, then the optimizer update, skipped on
        a non-finite gradient. `mark` is an optional phase-timing callback,
        called with the name of each phase as its work has been enqueued:
        'encoder', 'sampler', 'decoder_forward', 'decoder_backward',
        'encoder_backward', 'optimizer'. Metrics (device tensors, the JAX
        package's names): total_loss, grad_norm, grads_finite, params_finite,
        sample_ok, sample_ok_frac, solid_sbs, air_sbs, loss_dens, loss_rgb,
        loss_segm, loss_track.
    '''
    params = optimizer.params

    def step(batch, generator, mark=None):
        loss, (losses, aux) = pipeline.loss(batch, generator, mark)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        if mark is not None:
            mark('encoder_backward')
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        with torch.no_grad():
            grads_finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
            grad_norm = torch.sqrt(sum((g * g).sum() for g in grads))
            optimizer.update(grads, grad_norm, grads_finite)
            params_finite = torch.stack([torch.isfinite(p).all() for p in params]).all()
        if mark is not None:
            mark('optimizer')
        metrics = dict(total_loss=loss.detach(), grad_norm=grad_norm,
                       grads_finite=grads_finite, params_finite=params_finite,
                       sample_ok=aux['sample_ok'], sample_ok_frac=aux['sample_ok_frac'],
                       solid_sbs=aux['solid_sbs'], air_sbs=aux['air_sbs'],
                       **{f'loss_{k}': v.detach() for k, v in losses.items()})
        return metrics

    return step


def _to_device(batch, dev):
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(dev)
        else:  # a copy: the step never aliases the caller's numpy buffers.
            out[k] = torch.tensor(np.array(v), device=dev)
    return out


class Trainer:
    '''Models, optimizer and generator of one training run.
    `fused_attention` ('auto'|'on'|'off', None = 'auto') is the encoder's
    self-attention path, forwarded to build_models as the JAX Trainer
    forwards it; 'on' trains through the fused self-attention kernels.
    cfg.fused_decoder_dtype is the fused decoder's compute dtype
    (TrainPipeline); cfg.mixed_precision builds the networks in bf16
    (self.dtype) and sets AdamW's eps to 1e-4.'''

    def __init__(self, cfg, data_kind='greater', device='cuda', fused_attention=None):
        resolve_decoder_dtype(cfg.fused_decoder_dtype)
        self.cfg = cfg
        self.data_kind = data_kind
        self.device = resolve_device(device)
        self.fused_attention = fused_attention
        self.dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # bf16 products sum in f32 (cuBLAS may otherwise reduce in bf16).
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        (self.encoder, self.decoder, self.encoder_args,
         self.decoder_args) = build_models(cfg, fused_attention=fused_attention,
                                           dtype=self.dtype)
        self.sampler_args = build_sampler_args(cfg, data_kind)
        self.pipeline_cfg = PipelineConfig(
            color_mode=cfg.color_mode, semantic_classes=cfg.semantic_classes,
            past_frames=cfg.past_frames, future_frames=cfg.future_frames,
            density_lw=cfg.density_lw, color_lw=cfg.color_lw,
            segmentation_lw=cfg.segmentation_lw, tracking_lw=cfg.tracking_lw)
        self.optimizer = None
        self.generator = None
        self._step = None

    def init_state(self, params=None, seed=None, steps_per_epoch=1000):
        '''
        :param params: optional {'encoder', 'decoder'} flax-layout variables
            (numpy leaves), loaded through checkpoint.from_jax_params; else
            the modules' own initialization under torch.manual_seed(seed).
        :param seed: seeds the run's generator (default cfg.seed).
        '''
        seed = self.cfg.seed if seed is None else seed
        if params is None:
            torch.manual_seed(seed)
            (self.encoder, self.decoder, _, _) = build_models(
                encoder_args=self.encoder_args, decoder_args=self.decoder_args,
                fused_attention=self.fused_attention, dtype=self.dtype)
        else:
            self.encoder.load_state_dict(from_jax_params(params['encoder'], self.encoder),
                                         strict=True)
            self.decoder.load_state_dict(from_jax_params(params['decoder'], self.decoder),
                                         strict=True)
        self.encoder = self.encoder.to(self.device).train()
        self.decoder = self.decoder.to(self.device).train()
        self.pipeline = TrainPipeline(self.encoder, self.decoder,
                                      SamplerConfig(**self.sampler_args), self.pipeline_cfg,
                                      self.cfg.fused_decoder_dtype)
        named = list(self.encoder.parameters()) + list(self.decoder.parameters())
        self.optimizer = build_optimizer(self.cfg, steps_per_epoch, named)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self._step = make_train_step(self.pipeline, self.optimizer)
        return self

    def step(self, batch, mark=None):
        '''One train step on a batch dict (numpy arrays or tensors). Raises
        on a non-finite parameter; a non-finite gradient skips the update
        (metrics['grads_finite'] is then False). `mark`: the optional
        phase-timing callback of make_train_step.'''
        metrics = self._step(_to_device(batch, self.device), self.generator, mark)
        if not bool(metrics['params_finite']):
            raise RuntimeError('NaN model parameter detected!')
        return metrics
