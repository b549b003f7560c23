'''
The train driver (port of occlusions4d_tpu/train.py): AdamW with a
piecewise-constant learning rate, global-norm gradient clipping, the skip of
a step whose gradients are not finite and the hard failure on a non-finite
parameter, around the TrainPipeline forward; the epoch loop, checkpoints,
resume and the intermediate exports.

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
count as they were. Batch norm's running statistics (buffers, which AdamW
never sees) take the update the step's forward computed after the optimizer
step, or keep their old values on such a skipped step (the JAX step's
merge of the batch_stats collection and its jnp.where); the val_aug and viz
steps normalise with the batch's statistics and drop the update. All of it stays on the device: the step count is a
tensor and the skip is a torch.where, so the update never waits for the host.
Trainer.step reads params_finite after every step; Trainer.run_epoch reads
a step's flags only after the next step is queued (the JAX loop's lagged
guard), so the host never waits on the step it has just queued.

run_epoch draws from one torch.Generator per epoch and stage, seeded as the
JAX loop seeds its key (seed * 1000 + epoch * 10 + 0 for train, 1 for val),
so a run resumed after epoch e draws what an unbroken run draws. It
tolerates up to 11 host-side data errors per epoch (the 12th re-raises)
and logs the scalars every LOG_EVERY steps.

Observability, as in the JAX Trainer:
  * --watch_networks (on also with --use_wandb, wandb.watch's telemetry):
    on the logged steps the step stacks the L2 norm of every parameter's
    gradient (the all-reduced one under data parallelism) and of every
    parameter after the update into two device tensors, which run_epoch
    reports as train/grad_norm/<net>.<state-dict key> and
    train/param_norm/<...> (remembered, committed as epoch histograms);
  * spans and counters (utils/profiling.py), recorded while a device trace
    records or after profiling.record_spans(True), else one check each: the
    epoch is the span train.epoch, tiled by train.data, each step's root
    span <stage>_step_<i>, train.guard (the lagged guard's read), train.viz
    and train.log_sync (the LOG_EVERY fetch and report); the step is tiled
    by train.h2d (the batch's copy), train.encoder, train.sampler,
    train.decoder_fwd (the decoder and the losses), train.decoder_bwd (to
    the gradient reaching the abstract cloud), train.encoder_bwd,
    train.all_reduce (under a group) and train.optimizer (clip, AdamW, the
    guards, the batch statistics), each starting on the card where the
    last ended, so their device times sum to the step's; the kernels'
    o4d_<kernel> spans nest inside. Counters: train.steps,
    train.steps_skipped (a non-finite gradient read by the guard),
    train.data_errors, train.queries_sampled (frames x queries);
  * --profile_steps N: a device trace of train steps [1, 1 + N) of epoch 0
    under <log_dir>/profile, each step a span train_step_<i>, closed when
    the loop raises too; rank 0's alone; beside it spans.json
    (profiling.span_totals() and counters() of those steps: calls, host,
    device and self ms a span), also logged as a table;
  * --check_numerics: the pipeline's named NaN/Inf probes (pipeline.py) in
    the train, val_aug and viz forwards, with the decoder's module path,
    the encoder's plain attention chain and no remat, as the JAX Trainer
    forces its XLA paths for checkify;
  * --fused_decoder off: the decoder's module path, each frame recomputed
    in the backward (TrainPipeline's remat).

Checkpoints are the JAX package's pkl envelope (checkpoint.py): the JAX
evaluation loads what the port writes, and the port resumes from either
package's files (the JAX optimizer's moments come out of optax's
ScaleByAdamState); the JAX Trainer cannot resume from the port's optimizer
dicts.

The fused decoder computes in cfg.fused_decoder_dtype (pipeline.py:
'auto' is f32 here; 'bf16' runs the decoder's kernels in their bf16 mode,
forward and backward, and its plain products in TF32, models/fused.py).
cfg.mixed_precision builds both networks in bf16 (models/layers.py: bf16
linear layers over f32 parameters; the encoder's fused self-attention in
its bf16 mode with fused_attention='on'), as the JAX Trainer does
(train.py:254), with AdamW's eps 1e-4; the fused decoder then reads the
bf16 encoder's outputs in its own compute dtype. Entry points run on CUDA
unless asked for the CPU (cfg.device, --device cpu); TF32 stays off outside
that decoder.

    python -m occlusions4d_torch.train [flags of config.TrainConfig]
'''

import contextlib
import logging
import math
import os
import time

import numpy as np
import torch

from . import parallel, resolve_device
from .checkpoint import (adam_state, from_jax_params, jax_moments_to_torch,
                         load_checkpoint, load_reference_checkpoint,
                         resolve_checkpoint_file, save_checkpoint, to_jax_params)
from .config import TrainConfig, train_args
from .losses import total_loss
from .models.factory import build_models, build_sampler_args
from .models.layers import commit_batch_stats, set_norm_group
from .parallel import all_reduce_flat
from .pipeline import PipelineConfig, TrainPipeline, resolve_decoder_dtype
from .sampler import SamplerConfig
from .utils import profiling
from .utils.logvis import StepLogger

__all__ = ['AdamW', 'build_optimizer', 'make_train_step', 'make_eval_step',
           'make_viz_step', 'Trainer', 'main', 'LOG_EVERY']

# Host-sync cadence of the scalar logging (the JAX loop's), and of the
# per-layer norms of --watch_networks, computed on the logged steps only.
LOG_EVERY = 32
# The batch entries that stay on the host (bookkeeping and visuals).
_HOST_KEYS = ('meta_data', 'rgb', 'depth', 'flat', 'snitch', 'cam_RT', 'cam_K')


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


def _logged_losses(loss, losses, aux, cfg):
    '''(total, {name: loss}) to report: the global batch's under data
    parallelism (pipeline.py), else the step's own.'''
    if 'global_losses' in aux:
        return total_loss(aux['global_losses'], cfg), aux['global_losses']
    return loss.detach(), {k: v.detach() for k, v in losses.items()}


def _leaf_norms(tensors):
    '''(L,) L2 norms of the tensors, in f32, stacked on their device.'''
    return torch.stack([torch.sqrt(torch.sum(torch.square(t.detach().to(torch.float32))))
                        for t in tensors])


@contextlib.contextmanager
def _backward_spans(abstract):
    '''The backward's two tiled spans: train.decoder_bwd from its start to
    the gradient reaching the abstract cloud (a hook, registered only while
    spans record), then train.encoder_bwd to the end of the block. The hook
    runs on the autograd engine's thread, hence begin / end.'''
    dec = profiling.begin('train.decoder_bwd', tile=True)
    if dec is None:
        yield
        return
    enc = []

    def reached(grad):
        profiling.end(dec)
        enc.append(profiling.begin('train.encoder_bwd', tile=True, parent=dec.parent))

    handle = abstract.register_hook(reached) if abstract.requires_grad else None
    try:
        yield
    finally:
        if handle is not None:
            handle.remove()
        profiling.end(enc[0] if enc else dec)


def make_train_step(pipeline: TrainPipeline, optimizer: AdamW, watch_networks=False):
    '''
    :return step(batch, generator, mark=None, want_norms=True) -> metrics:
        forward and backward through the pipeline, then the optimizer
        update, skipped on a non-finite gradient. `mark` is an optional
        phase-timing callback,
        called with the name of each phase as its work has been enqueued:
        'encoder', 'sampler', 'decoder_forward', 'decoder_backward',
        'encoder_backward', ('gradient_all_reduce',) 'optimizer'. Metrics
        (device tensors, the JAX package's names): total_loss, grad_norm,
        grads_finite, params_finite (the parameters and the batch-norm
        statistics), sample_ok, sample_ok_frac, solid_sbs, air_sbs,
        loss_dens, loss_rgb, loss_segm, loss_track; with watch_networks, on
        a step with want_norms, also layer_grad_norms and layer_param_norms:
        (P,) tensors, one norm per parameter of optimizer.params, of its
        gradient and of its value after the update.
    Under the pipeline's data-parallel group, each rank's gradients of its
    share of the loss are summed over the group in one all-reduce of their
    concatenation ('gradient_all_reduce'), before the norm, the clip and the
    skip, so every rank takes the same update; the metrics are the global
    batch's.
    '''
    params = optimizer.params
    group = pipeline.group

    def step(batch, generator, mark=None, want_norms=True):
        loss, (losses, aux) = pipeline.loss(batch, generator, mark)
        profiling.count('train.steps')
        profiling.count('train.queries_sampled', math.prod(aux['points_query'].shape[:-1]))
        with _backward_spans(aux['abstract']):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        if mark is not None:
            mark('encoder_backward')
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if group is not None:
            with profiling.span('train.all_reduce', tile=True):
                grads = all_reduce_flat(grads, group)
            if mark is not None:
                mark('gradient_all_reduce')
        with profiling.span('train.optimizer', tile=True), torch.no_grad():
            grads_finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
            grad_norm = torch.sqrt(sum((g * g).sum() for g in grads))
            optimizer.update(grads, grad_norm, grads_finite)
            commit_batch_stats(aux['batch_stats'], grads_finite)
            stats = [t for layer, _, _ in aux['batch_stats']
                     for t in (layer.running_mean, layer.running_var)]
            params_finite = torch.stack([torch.isfinite(p).all()
                                         for p in params + stats]).all()
        if mark is not None:
            mark('optimizer')
        total, logged = _logged_losses(loss, losses, aux, pipeline.cfg.loss_config)
        metrics = dict(total_loss=total, grad_norm=grad_norm,
                       grads_finite=grads_finite, params_finite=params_finite,
                       sample_ok=aux['sample_ok'], sample_ok_frac=aux['sample_ok_frac'],
                       solid_sbs=aux['solid_sbs'], air_sbs=aux['air_sbs'],
                       **{f'loss_{k}': v for k, v in logged.items()})
        if watch_networks and want_norms:
            metrics['layer_grad_norms'] = _leaf_norms(grads)
            metrics['layer_param_norms'] = _leaf_norms(params)
        return metrics

    return step


def make_eval_step(pipeline: TrainPipeline):
    '''
    :return step(batch, generator) -> metrics: the pipeline's losses without
        a gradient (total_loss, sample_ok, loss_*; device tensors; the global
        batch's under a data-parallel group).
    '''

    def step(batch, generator):
        with torch.no_grad():
            losses, aux = pipeline.forward(batch, generator)
            total, logged = _logged_losses(aux['total_loss'], losses, aux,
                                           pipeline.cfg.loss_config)
        return dict(total_loss=total, sample_ok=aux['sample_ok'],
                    **{f'loss_{k}': v for k, v in logged.items()})

    return step


def make_viz_step(pipeline: TrainPipeline):
    '''The observability forward, run every cfg.viz_interval train steps:
    :return viz(batch, generator) -> dict of device tensors (abstract,
        points_query, implicit_output, implicit_target, features_global,
        layer_coords), the pipeline re-run without a gradient and with
        return_intermediate.'''

    def viz(batch, generator):
        with torch.no_grad():
            _, aux = pipeline.forward(batch, generator, return_intermediate=True)
        return {k: aux[k] for k in ('abstract', 'points_query', 'implicit_output',
                                    'implicit_target', 'features_global', 'layer_coords')}

    return viz


def _numpy(t):
    return t.detach().to(torch.float32).cpu().numpy() if t.is_floating_point() \
        else t.detach().cpu().numpy()


def _to_device(batch, dev):
    '''The batch's step inputs on `dev` (the host-side entries left out), in
    the tiled span train.h2d.'''
    out = {}
    with profiling.span('train.h2d', tile=True):
        for k, v in batch.items():
            if k in _HOST_KEYS:
                continue
            if isinstance(v, torch.Tensor):
                out[k] = v.to(dev)
            else:  # a copy: the step never aliases the caller's numpy buffers.
                out[k] = torch.tensor(np.array(v), device=dev)
    return out


class Trainer:
    '''Models, optimizer and epoch loop of one training run.
    `device` (None = cfg.device) is where it trains; `fused_attention`
    ('auto'|'on'|'off', None = 'auto') is the encoder's self-attention path,
    forwarded to build_models as the JAX Trainer forwards it; 'on' trains
    through the fused self-attention kernels. cfg.fused_decoder ('auto' |
    'on' | 'off') and cfg.fused_decoder_dtype choose the decoder's path and
    its compute dtype (TrainPipeline); cfg.mixed_precision builds the
    networks in bf16 (self.dtype) and sets AdamW's eps to 1e-4.
    cfg.check_numerics forces the encoder's attention and the decoder onto
    their module paths, remat off, and the pipeline's probes on;
    cfg.watch_networks or cfg.use_wandb reports the per-layer norms
    (the module docstring).

    group (a parallel.Group, None for one process) makes this Trainer one
    rank of a data-parallel run on the group's device: its steps take its
    rows of each global batch (run_epoch receives them from rank 0, which
    alone reads `data_iter`), its losses, batch statistics and gradients are
    the group's (pipeline.py, train step), its generators are seeded per
    rank (parallel.rank_seed; rank 0 draws what one process draws), and
    only rank 0 writes checkpoints, logs and exports.'''

    def __init__(self, cfg, data_kind='greater', device=None, fused_attention=None,
                 logger=None, group=None):
        resolve_decoder_dtype(cfg.fused_decoder_dtype)
        self.cfg = cfg
        self.data_kind = data_kind
        self.group = group
        if group is not None:
            device = group.device
            if cfg.batch_size % group.size:
                raise ValueError(f'batch_size={cfg.batch_size} is not divisible by the '
                                 f'{group.size} data-parallel ranks')
            if device.type == 'cuda':     # the rank's card, for its collectives too.
                torch.cuda.set_device(device)
        self.device = resolve_device(cfg.device if device is None else device)
        self.check_numerics = cfg.check_numerics
        # The probes see tensors, not the inside of a fused operator: under
        # check_numerics both networks take their module paths (JAX's
        # checkify cannot see inside its Pallas kernels, so its Trainer
        # does the same), and remat is off, as in the JAX Trainer.
        self.fused_attention = 'off' if cfg.check_numerics else fused_attention
        self.fused_decoder = 'off' if cfg.check_numerics else cfg.fused_decoder
        self.watch_networks = cfg.watch_networks or cfg.use_wandb
        self.logger = logger or StepLogger(context='train', batch_size=cfg.batch_size)
        self.dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # bf16 products sum in f32 (cuBLAS may otherwise reduce in bf16).
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        (self.encoder, self.decoder, self.encoder_args,
         self.decoder_args) = build_models(cfg, fused_attention=self.fused_attention,
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
        self.step_count = 0            # train steps run (the JAX state's 'step').
        self.start_epoch = cfg.start_epoch

    # ------------------------------------------------------------------ state --

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
        if self.group is not None:   # every rank starts from rank 0's state.
            parallel.broadcast_flat(list(self.encoder.state_dict().values())
                                    + list(self.decoder.state_dict().values()), self.group)
            set_norm_group(self.encoder, self.group)
        self.pipeline = TrainPipeline(self.encoder, self.decoder,
                                      SamplerConfig(**self.sampler_args), self.pipeline_cfg,
                                      self.cfg.fused_decoder_dtype, group=self.group,
                                      fused_decoder=self.fused_decoder,
                                      remat=not self.check_numerics,
                                      debug_checks=self.check_numerics)
        self._nets = dict(encoder=self.encoder, decoder=self.decoder)
        self._param_names = [(net, n) for net, m in self._nets.items()
                             for n, _ in m.named_parameters()]
        # The per-layer norms' names, one a parameter in optimizer order.
        self.layer_names = [f'{net}.{n}' for net, n in self._param_names]
        named = list(self.encoder.parameters()) + list(self.decoder.parameters())
        self.optimizer = build_optimizer(self.cfg, steps_per_epoch, named)
        self.generator = torch.Generator(self.device).manual_seed(
            parallel.rank_seed(seed, self.group))
        self.step_count = 0
        self._step = make_train_step(self.pipeline, self.optimizer,
                                     watch_networks=self.watch_networks)
        self._eval_step = make_eval_step(self.pipeline)
        self._viz_step = make_viz_step(self.pipeline)
        return self

    def state(self):
        '''The checkpoint's state: params in the flax layout, the optimizer
        as {'mu', 'nu' (the params' layout), 'count'}, the step count; numpy.'''
        moments = {}
        for name, tensors in (('mu', self.optimizer.mu), ('nu', self.optimizer.nu)):
            per_net = {net: {} for net in self._nets}
            for (net, n), t in zip(self._param_names, tensors):
                per_net[net][n] = t
            moments[name] = {net: to_jax_params(d, net == 'decoder')
                             for net, d in per_net.items()}
        params = {net: to_jax_params(m.state_dict(), net == 'decoder')
                  for net, m in self._nets.items()}
        opt = dict(moments, count=np.asarray(int(self.optimizer.count), np.int32))
        return dict(params=params, opt_state=opt,
                    step=np.asarray(self.step_count, np.int32))

    def resume(self, path, steps_per_epoch=1000):
        '''Load a checkpoint (a file, or a run directory through
        checkpoint.resolve_checkpoint_file); training goes on at its epoch + 1.
        Either package's pkl restores the full state: the parameters (batch
        statistics included), AdamW's mu, nu and count, the step count. A
        reference .pth is a warm start, as in the JAX Trainer: its weights
        and epoch, AdamW fresh (zero moments and count, so the learning-rate
        schedule starts again), the step count at (epoch + 1) x
        steps_per_epoch.'''
        path = resolve_checkpoint_file(str(path))
        if path.endswith('.pth'):
            ref = load_reference_checkpoint(path)
            self.init_state(params=dict(encoder=ref['encoder_variables'],
                                        decoder=ref['decoder_variables']),
                            steps_per_epoch=steps_per_epoch)
            epoch = int(ref['epoch'])
            self.step_count = (epoch + 1) * steps_per_epoch
            self.start_epoch = epoch + 1
            self.logger.info('Resuming from a reference .pth checkpoint: weights + epoch '
                             'loaded, optimizer state reinitialized (torch Adam moments are '
                             'not bridged).')
            return self
        ck = load_checkpoint(path)
        self.init_state(params=ck['state']['params'], steps_per_epoch=steps_per_epoch)
        adam = adam_state(ck['state']['opt_state'])
        with torch.no_grad():
            for key, tensors in (('mu', self.optimizer.mu), ('nu', self.optimizer.nu)):
                per_net = {net: jax_moments_to_torch(adam[key][net], m)
                           for net, m in self._nets.items()}
                for (net, n), t in zip(self._param_names, tensors):
                    t.copy_(per_net[net][n].to(t.device))
            self.optimizer.count.fill_(adam['count'])
        self.step_count = int(np.asarray(ck['state'].get('step', adam['count'])))
        self.start_epoch = int(ck['epoch']) + 1
        return self

    @property
    def is_main(self):
        '''Whether this Trainer writes (one process, or rank 0).'''
        return self.group is None or self.group.is_main

    def save(self, epoch):
        '''model_{epoch}.pkl and the rolling checkpoint.pkl under
        cfg.output_path, with the JAX Trainer's meta; written by rank 0 alone,
        every rank waiting until it is (the same file a one-process run
        writes: the ranks' states are equal).'''
        if not self.cfg.output_path:
            return
        if self.is_main:
            meta = dict(config=dict(vars(self.cfg)), encoder_args=self.encoder_args,
                        decoder_args=self.decoder_args, sampler_args=self.sampler_args,
                        data_kind=self.data_kind)
            save_checkpoint(self.cfg.output_path, epoch, self.state(), meta=meta)
        parallel.barrier(self.group)

    # ------------------------------------------------------------------- steps --

    def step(self, batch, mark=None, want_norms=True):
        '''One train step on a batch dict (numpy arrays or tensors) with the
        run's generator. Raises on a non-finite parameter; a non-finite
        gradient skips the update (metrics['grads_finite'] is then False).
        `mark`: the optional phase-timing callback of make_train_step;
        want_norms: the per-layer norms, under watch_networks.'''
        metrics = self._step(_to_device(batch, self.device), self.generator, mark,
                             want_norms)
        self.step_count += 1
        if not bool(metrics['params_finite']):
            raise RuntimeError('NaN model parameter detected!')
        return metrics

    def run_epoch(self, epoch, stage, data_iter, num_steps=None):
        '''One epoch of `stage` ('train', or 'val' / 'val_aug': the losses
        without a step) over an iterable of batch dicts (of global batches,
        read by rank 0 alone, under a group: the other ranks pass None).
        Under a group the ranks agree, step by step, on a host-side data
        error (all skip the step), and all run the viz forward that rank 0's
        logger asks for. While spans record (utils/profiling.py) the epoch
        is the span train.epoch, tiled by train.data, the step's root span
        <stage>_step_<i> (train.h2d, train.encoder, train.sampler,
        train.decoder_fwd, train.decoder_bwd, train.encoder_bwd,
        train.all_reduce, train.optimizer), train.guard, train.viz and
        train.log_sync; counters train.steps, train.steps_skipped,
        train.data_errors and train.queries_sampled.
        :return the metrics of the logged steps (numpy).'''
        assert stage in ('train', 'val', 'val_aug')
        with profiling.span('train.epoch'):
            return self._run_epoch(epoch, stage, data_iter, num_steps)

    def _run_epoch(self, epoch, stage, data_iter, num_steps):
        span = profiling.span
        is_train = stage == 'train'
        group = self.group
        gen = torch.Generator(self.device).manual_seed(parallel.rank_seed(
            self.cfg.seed * 1000 + epoch * 10 + (0 if is_train else 1), group))
        self.generator = gen
        log_dir = parallel.broadcast_object(self.logger.log_dir, group)
        if group is not None:
            data_iter = parallel.rank_batches(data_iter, group)
        num_exceptions = 0
        metrics_hist = []
        start = time.time()
        data_iter = iter(data_iter)
        cur_step = -1
        prev_guard = None      # (grads_finite, params_finite) of the last train step.
        # --profile_steps: a device trace of steps [1, 1 + N) of epoch 0 (step
        # 0 pays the warm-up and would drown it), rank 0's, and the spans of
        # those steps in spans.json beside it.
        prof_until = (1 + self.cfg.profile_steps
                      if (is_train and epoch == 0 and log_dir and self.is_main
                          and self.cfg.profile_steps > 0) else None)
        prof_active = False
        prof_mark = None       # the store's position when the trace started.
        prof_dir = os.path.join(log_dir, 'profile') if log_dir else None

        def prof_stop():
            nonlocal prof_active
            if prof_active:
                prof_active = False
                if self.device.type == 'cuda':    # the traced steps' kernels done.
                    torch.cuda.synchronize(self.device)
                profiling.stop_trace()
                os.makedirs(prof_dir, exist_ok=True)
                totals, counts = profiling.write_spans(os.path.join(prof_dir, 'spans.json'),
                                                       since=prof_mark)
                self.logger.info(f'Device trace and spans.json written to {prof_dir}; '
                                 f'spans:\n' + profiling.spans_table(totals, counts))

        def check_guard():
            '''Read and act on the pending step's guard flags.'''
            nonlocal prev_guard
            if prev_guard is None:
                return
            with span('train.guard', tile=True):
                g_fin, p_fin = bool(prev_guard[0]), bool(prev_guard[1])
            prev_guard = None
            if not g_fin:
                profiling.count('train.steps_skipped')
                self.logger.error('NaN/Inf gradient detected! Step skipped.')
            if not p_fin:
                raise RuntimeError('NaN model parameter detected!')

        try:
            while True:
                cur_step += 1
                if prof_until is not None:
                    if prof_active and cur_step >= prof_until:
                        prof_stop()
                    elif not prof_active and cur_step == 1:
                        # The spans of an outer recording stay (record_spans).
                        profiling.start_trace(prof_dir)
                        prof_mark = profiling.mark()
                        prof_active = True
                if num_steps is not None and cur_step >= num_steps:
                    break
                with span('train.data', tile=True):
                    batch = next(data_iter, None)
                if batch is None:
                    break
                with span(f'{stage}_step_{cur_step}', tile=True, root=True):
                    agreed = False
                    try:
                        if isinstance(batch, Exception):   # a batch rank 0 could not shard.
                            raise batch
                        meta_list = batch.get('meta_data')
                        host_images = {k: batch[k] for k in ('rgb', 'depth') if k in batch}
                        batch = _to_device(batch, self.device)
                        # Every rank runs the step, or none: a skip on one rank
                        # alone would leave the others waiting in the step's
                        # collectives.
                        agreed = True
                        if not parallel.all_true(True, group):
                            raise RuntimeError('a host-side data error on another rank')
                    except Exception as e:  # host-side data failure tolerance.
                        if not agreed:
                            parallel.all_true(False, group)
                        num_exceptions += 1
                        profiling.count('train.data_errors')
                        if num_exceptions >= 12:
                            raise
                        self.logger.exception(e)
                        # A pending poison pill must not be masked by a
                        # data-failure streak ending in the 12-exception re-raise.
                        check_guard()
                        continue

                    viz_due = (is_train and log_dir is not None
                               and cur_step % max(self.cfg.viz_interval, 1) == 0)
                    if viz_due:  # the step's draws, on a copy that leaves `gen` as it is.
                        viz_gen = torch.Generator(self.device)
                        viz_gen.set_state(gen.get_state())
                    if is_train:
                        metrics = self._step(batch, gen, want_norms=cur_step % LOG_EVERY == 0)
                        self.step_count += 1
                        new_guard = (metrics['grads_finite'], metrics['params_finite'])
                    else:
                        metrics = self._eval_step(batch, gen)
                        new_guard = None

                # The guard of step N is read after step N + 1 is queued: the
                # read waits on a step already retiring, and the poison-pill
                # raise still precedes the dispatch of step N + 2 (the one step
                # queued on poisoned parameters is a skipped no-op where the
                # poisoned leaf touches the loss).
                if is_train:
                    check_guard()
                    prev_guard = new_guard

                if viz_due:
                    with span('train.viz', tile=True):
                        self._export_intermediates(epoch, stage, cur_step, batch,
                                                   host_images, meta_list, viz_gen)

                if cur_step % LOG_EVERY == 0:   # host sync for scalar logging only.
                    with span('train.log_sync', tile=True):
                        self._log_step(epoch, stage, cur_step, num_steps, metrics,
                                       metrics_hist)

        finally:
            # Close an active trace when the loop raises too (a NaN
            # parameter, a data error): an unfinished trace is lost.
            prof_stop()
        check_guard()  # trailing-edge guard for the final step.
        self.logger.info(f'[{stage}] epoch {epoch} finished in {time.time() - start:.1f}s')
        return metrics_hist

    def _log_step(self, epoch, stage, cur_step, num_steps, metrics, metrics_hist):
        '''Fetch a logged step's metrics to the host, report them and append
        them to metrics_hist.'''
        m = {k: _numpy(v) for k, v in metrics.items()}
        loss_terms = {k: float(v) for k, v in m.items() if k.startswith('loss_')}
        self.logger.handle_step(epoch, stage, cur_step, cur_step, num_steps or -1,
                                float(m['total_loss']), loss_terms)
        for name, val in loss_terms.items():
            self.logger.report_scalar(f'{stage}/{name}', val, remember=True)
        self.logger.report_scalar(f'{stage}/total_loss', float(m['total_loss']),
                                  remember=True)
        if 'layer_grad_norms' in m and self.is_main:
            # wandb.watch's telemetry, committed as epoch histograms.
            for kind in ('layer_grad_norms', 'layer_param_norms'):
                for name, val in zip(self.layer_names, m[kind]):
                    self.logger.report_scalar(
                        f'{stage}/{kind[6:-1]}/{name}', float(val),
                        remember=True, commit_histogram=True)
        metrics_hist.append(m)

    def _export_intermediates(self, epoch, stage, cur_step, dev_batch, host_images,
                              meta_list, generator):
        '''npy point-cloud exports of input / abstract / target / implicit
        output / per-layer coordinates, per-channel output histograms, the
        dataset's filtering-ratio histograms, and early-epoch RGB-D galleries
        and the RGB video when images were loaded (the JAX Trainer's; the
        video where the optional imageio package is installed).
        Under a group every rank runs the forward (its statistics are the
        group's) and rank 0 exports its rows' (example 0 is the global
        batch's first).'''
        raw = self._viz_step(dev_batch, generator)
        if not self.is_main:
            return
        viz = {k: _numpy(v) for k, v in raw.items() if k != 'layer_coords'}
        out_pcl = np.concatenate([viz['points_query'][0], viz['implicit_output'][0]],
                                 axis=-1)                      # (T, N, 4 + C).
        tgt_pcl = np.concatenate([viz['points_query'][0], viz['implicit_target'][0]],
                                 axis=-1)                      # (T, N, 10).
        arrays = dict(pcl_input=_numpy(dev_batch['pcl_input'][0]),
                      pcl_abstract=viz['abstract'][0],
                      pcl_target=_numpy(dev_batch['pcl_target'][0]),
                      implicit_output=out_pcl, implicit_target=tgt_pcl)
        for i, lc in enumerate(raw['layer_coords'] or []):
            arrays[f'layer_coords_{i}'] = _numpy(lc[0])
        self.logger.export_pointclouds(stage, epoch, cur_step, arrays)

        cfg = self.cfg
        for t in range(viz['implicit_output'].shape[1]):
            io_t = viz['implicit_output'][:, t]
            self.logger.report_implicit_histograms(
                stage, io_t, cfg.color_mode, t, cfg.segmentation_lw > 0.0,
                cfg.semantic_classes, cfg.tracking_lw > 0.0, step=epoch)
            # Predicted-solid vs predicted-air per-channel split at density
            # logit 0.
            flat = io_t.reshape(-1, io_t.shape[-1])
            self.logger.report_pcl_air_histograms(
                stage, flat[flat[..., 0] >= 0.0], flat[flat[..., 0] < 0.0],
                cfg.color_mode, t, cfg.segmentation_lw > 0.0, cfg.semantic_classes,
                cfg.tracking_lw > 0.0, False, epoch)
        self.logger.report_histogram(f'{stage}/features_global', viz['features_global'],
                                     step=epoch)
        self.logger.report_filter_ratios(stage, meta_list, epoch)

        if host_images and epoch < 2 and cur_step == 0:
            rgb = np.asarray(host_images['rgb'][0, 0])           # (T, H, W, 3).
            self.logger.save_gallery(rgb, f'{stage}_rgb_e{epoch}', step=cur_step)
            try:
                self.logger.save_video(rgb, f'{stage}_rgb_e{epoch}', step=cur_step)
            except ImportError as e:
                self.logger.info(f'the RGB video is not written: the optional package '
                                 f'imageio is not installed ({e}); the gallery is')
            if 'depth' in host_images:
                d = np.asarray(host_images['depth'][0, 0])
                d = d / max(float(d.max()), 1e-6)
                self.logger.save_gallery(d, f'{stage}_depth_e{epoch}', step=cur_step)

    def fit(self, train_loader_fn, val_loader_fn=None, steps_per_epoch=None):
        '''
        :param train_loader_fn: epoch -> iterable of batches (val likewise).
        '''
        for epoch in range(self.start_epoch, self.cfg.num_epochs):
            self.logger.info(f'Epoch (1-based): {epoch + 1} / {self.cfg.num_epochs}')
            self.run_epoch(epoch, 'train', train_loader_fn(epoch), steps_per_epoch)
            self.save(epoch)
            if val_loader_fn is not None:
                self.run_epoch(epoch, 'val_aug', val_loader_fn(epoch), steps_per_epoch)
            self.logger.epoch_finished(epoch)


def main(cfg: TrainConfig, logger=None, devices=None):
    '''The command line's entry: loaders, Trainer (fresh, or resumed from
    cfg.resume), the epochs. Trains on cfg.device ('cuda' raises without a
    card) over the devices of cfg.data_parallel (parallel.
    resolve_data_parallel: -1 is the largest divisor of the batch that the
    host's cards hold), or over `devices` where given (a list such as
    ['cuda:0', 'cuda:0']: two ranks on one card). Under torchrun this
    process is the rank its environment names, on cuda:LOCAL_RANK (or the
    CPU with --device cpu). More than one device spawns a rank each
    (parallel.spawn, the kernels built first), rank 0 reading the data.
    :return the Trainer; None where ranks were spawned.'''
    env = parallel.torchrun_env()
    if env is not None:
        rank, size, local = env
        cpu = torch.device(cfg.device).type == 'cpu'
        group = parallel.init_group(rank, size, 'cpu' if cpu else f'cuda:{local}',
                                    'gloo' if cpu else 'nccl')
        try:
            return _run(group, cfg, logger)
        finally:
            parallel.destroy_group()
    if devices is None:
        devices = parallel.resolve_data_parallel(cfg.data_parallel, cfg.batch_size,
                                                 cfg.device)
    if len(devices) == 1:
        return _run(None, cfg, logger)
    if any(torch.device(d).type == 'cuda' for d in devices):
        from .ops import _build
        _build.build_all()            # once, before the ranks would race to.
    run_dir = cfg.output_path or os.path.join(cfg.log_root, cfg.tag or cfg.name or 'run')
    parallel.spawn(_run, devices, args=(cfg,), run_dir=run_dir)
    return None


def _run(group, cfg, logger=None):
    '''One process's training run: all of it, or rank group.rank's.'''
    from .data import create_train_val_loaders
    main_rank = group is None or group.is_main
    if logger is None:
        logger = StepLogger(
            log_dir=os.path.join(cfg.log_root, cfg.tag or cfg.name or 'run') if main_rank
            else None, context='train' if main_rank else f'train_rank{group.rank}',
            batch_size=cfg.batch_size)
        if not main_rank:   # rank 0 reports; the others only warn.
            logger.logger.setLevel(logging.WARNING)
    logger.info(f'Args: {cfg}')
    if main_rank:
        logger.save_args(cfg)
        logger.use_wandb = logger.use_wandb or cfg.use_wandb
        logger.init_wandb('occlusions-4d', cfg)
    np.random.seed(cfg.seed)

    # Before anything touches CUDA (init_group leaves it alone; the Trainer
    # selects the card): --worker_mode process forks the loaders' workers
    # here. Rank 0 alone reads the data.
    train_loader = val_loader = None
    if main_rank:
        data_kind, train_loader, val_loader, _ = create_train_val_loaders(cfg, logger)
        info = (data_kind, train_loader.steps_per_epoch, val_loader is not None)
    info = parallel.broadcast_object(info if main_rank else None, group)
    data_kind, steps_per_epoch, has_val = info
    logger.info(f'data_kind: {data_kind}  output: {cfg.output_path}')
    trainer = Trainer(cfg, data_kind, logger=logger, group=group)
    if cfg.resume:
        trainer.resume(cfg.resume, steps_per_epoch)
        logger.info(f'Resumed from {cfg.resume} at epoch {trainer.start_epoch}')
    else:
        trainer.init_state(steps_per_epoch=steps_per_epoch)
    trainer.fit(lambda e: train_loader.epoch(e) if main_rank else None,
                (lambda e: val_loader.epoch(e) if main_rank else None) if has_val else None,
                steps_per_epoch=steps_per_epoch)
    return trainer


if __name__ == '__main__':
    main(train_args())
