'''
The reference train step: encode the input video, sample each frame's
queries, evaluate the field on them (the plain module decoder, each frame
recomputed in the backward so that the (N, K, D) rows of one frame are held
at a time), squash, take the masked losses, differentiate, clip by the
global norm and take optax's AdamW step.

A frozen copy of the f32 single-process parts of occlusions4d_torch's
pipeline.py, losses.py and train.py (AdamW), without data parallelism, batch
norm or the fused decoder. The generator is seeded as the port's
Trainer.run_epoch seeds an epoch's (seed * 1000 + epoch * 10 for 'train').
'''

import contextlib

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from .models import build_models, track_idx
from .sampler import GuidedPointSampler, SamplerConfig

B1, B2, WEIGHT_DECAY, EPS = 0.9, 0.999, 1e-2, 1e-8


def sampler_config(cfg, data_kind):
    return SamplerConfig(
        min_z=cfg['min_z'], cube_bounds=cfg['cr_cube_bounds'],
        point_occupancy_radius=cfg['point_occupancy_radius'], num_solid=cfg['num_cr_solid'],
        num_air=int(cfg['num_cr_solid'] * cfg['air_sampling_ratio']),
        predict_segmentation=cfg['segmentation_lw'] > 0.0,
        semantic_classes=cfg['semantic_classes'], predict_tracking=cfg['tracking_lw'] > 0.0,
        data_kind=data_kind, point_sample_bias=cfg['point_sample_bias'],
        cube_mode=cfg['cube_mode'])


def squash_colors(out, color_mode):
    '''Train-time squash: density stays a logit, rgb_nosigmoid is clamped.'''
    if color_mode == 'rgb':
        return torch.cat([out[..., :1], torch.sigmoid(out[..., 1:4]), out[..., 4:]], -1)
    if color_mode == 'rgb_nosigmoid':
        return torch.cat([out[..., :1], torch.clamp(out[..., 1:4], 0.0, 1.0),
                          out[..., 4:]], -1)
    raise ValueError(f'the reference has no color mode {color_mode!r}')


def _sigmoid_bce(logits, labels):
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def _masked_mean(values, mask):
    mask = mask.to(values.dtype)
    denom = mask.sum(-1)
    return torch.where(denom > 0, (values * mask).sum(-1) / torch.clamp(denom, min=1.0),
                       torch.zeros_like(denom))


def slice_losses(output, target, cfg):
    '''(B, T) losses of each (example, frame) slice: density BCE, colour L1,
    segmentation CE, tracking BCE; a zero-weight term is zeros.'''
    z = torch.zeros(output.shape[:-2], dtype=output.dtype, device=output.device)
    dens = _sigmoid_bce(output[..., 0], target[..., 0]).mean(-1)
    rgb = segm = track = z
    if cfg['color_lw'] > 0:
        mask = (target[..., 0] >= 0.1) & (target[..., 1] >= 0.0)
        rgb = _masked_mean((output[..., 1:4] - target[..., 1:4]).abs().mean(-1), mask)
    if cfg['segmentation_lw'] > 0:
        n = cfg['semantic_classes']
        segm_t = target[..., -1].to(torch.int64)
        logits = output[..., -n:]
        label = torch.clamp(segm_t, 0, n - 1)
        ce = torch.logsumexp(logits, -1) - torch.gather(logits, -1, label[..., None])[..., 0]
        segm = _masked_mean(ce, segm_t >= 0)
    if cfg['tracking_lw'] > 0:
        mask = (target[..., 0] >= 0.1) & (target[..., 4] >= 0.0)
        bce = _sigmoid_bce(output[..., track_idx(cfg['color_mode'])],
                           torch.clamp(target[..., 4], 0.0, 1.0))
        track = _masked_mean(bce, mask)
    return dict(dens=dens, rgb=rgb, segm=segm, track=track)


def total_loss(losses, cfg):
    return (losses['rgb'] * cfg['color_lw'] + losses['dens'] * cfg['density_lw']
            + losses['segm'] * cfg['segmentation_lw'] + losses['track'] * cfg['tracking_lw'])


class TrainReference:
    '''Networks, sampler and AdamW of one training run of `cfg` (a dict of
    the TrainConfig fields) on `device`, from the given weights.'''

    def __init__(self, cfg, data_kind, weights, device, rows=None):
        self.cfg = cfg
        self.encoder, self.decoder = build_models(cfg)
        self.encoder.to(device).train()
        self.decoder.to(device).train()
        load_weights(self, weights)
        self.sampler = GuidedPointSampler(sampler_config(cfg, data_kind))
        self.params = list(self.encoder.parameters()) + list(self.decoder.parameters())
        self.names = ([f'encoder.{n}' for n, _ in self.encoder.named_parameters()]
                      + [f'decoder.{n}' for n, _ in self.decoder.named_parameters()])
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.device = torch.device(device)
        # A planted fault for the checks of the comparison: only these rows
        # of each batch take part (the mean then over them alone).
        self.rows = rows

    def _frame(self, points_query, abstract, fg):
        return self.decoder(points_query, abstract, fg)

    def loss(self, batch, gen):
        cfg = self.cfg
        abstract, fg = self.encoder(batch['pcl_input'], generator=gen)
        tgt_all, valid_all = batch['pcl_target'], batch['pcl_target_valid']
        B, T = tgt_all.shape[:2]
        ex = torch.arange(B, device=tgt_all.device)
        outputs, targets, oks = [], [], []
        for t in range(T):
            if T > 1:
                other_t = torch.randint(0, T - 1, (B,), generator=gen, device=tgt_all.device)
                other_t = torch.where(other_t == t, other_t + 1, other_t)
            else:
                other_t = torch.zeros((B,), dtype=torch.int64, device=tgt_all.device)
            s = self.sampler.sample_frame(gen, tgt_all[:, t], valid_all[:, t],
                                          tgt_all[ex, other_t], valid_all[ex, other_t],
                                          batch['valo_ids'], batch['num_valo_ids'], t)
            pq = torch.cat([s['solid_input'], s['air_input']], 1).detach()
            out = checkpoint(self._frame, pq, abstract, fg, use_reentrant=False,
                             preserve_rng_state=False)
            outputs.append(squash_colors(out, cfg['color_mode']))
            targets.append(torch.cat([s['solid_target'], s['air_target']], 1).detach())
            oks.append(s['ok'])
        output, target = torch.stack(outputs, 1), torch.stack(targets, 1)
        w = torch.stack(oks, 1).to(output.dtype)
        if self.rows is not None:
            output, target, w = output[self.rows], target[self.rows], w[self.rows]
        sliced = slice_losses(output, target, cfg)
        denom = torch.clamp(w.sum(), min=1.0)
        return total_loss({k: (v * w).sum() / denom for k, v in sliced.items()}, cfg)

    def lr(self):
        '''learn_rate, scaled by lr_decay past each boundary (none is reached
        in the first steps of a run of num_epochs x steps_per_epoch).'''
        return self.cfg['learn_rate']

    def step(self, batch, gen):
        '''One step. :return (loss, clipped gradients as AdamW takes them).'''
        loss = self.loss(batch, gen)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            clip = self.cfg['gradient_clip']
            if clip > 0 and float(norm) >= clip:
                grads = [(g / norm) * clip for g in grads]
            self.count += 1
            bc1, bc2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
            for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
                mu.mul_(B1).add_((1.0 - B1) * g)
                nu.mul_(B2).add_((1.0 - B2) * (g * g))
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS) + WEIGHT_DECAY * p
                p.add_(-self.lr() * u)
        return float(loss.detach()), grads


@contextlib.contextmanager
def precision(tf32):
    '''Matrix products in f32 (TF32 off), or in TF32 with tf32; the global
    settings restored on exit.'''
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def load_weights(ref, weights):
    '''Copy {'encoder.<name>' / 'decoder.<name>': tensor} into the networks.'''
    with torch.no_grad():
        for net, mod in (('encoder', ref.encoder), ('decoder', ref.decoder)):
            for n, p in mod.named_parameters():
                p.copy_(weights[f'{net}.{n}'])


def run_steps(cfg, data_kind, weights, batches, seed, device, n_steps=3, rows=None,
              tf32=False):
    '''The first n_steps of a run from `weights` on `batches` (dicts of
    tensors on `device`), epoch 0's generator; f32 products, or TF32 ones
    with tf32 (the check's control, one precision below the stated one).
    :return dict(losses [n], grad_norms {leaf: norm of the first step's
        clipped gradient}, change_norms {leaf: norm of the parameters'
        change after n_steps}).'''
    with precision(tf32):
        return _run_steps(cfg, data_kind, weights, batches, seed, device, n_steps, rows)


def _run_steps(cfg, data_kind, weights, batches, seed, device, n_steps, rows):
    ref = TrainReference(cfg, data_kind, weights, device, rows=rows)
    before = [p.detach().clone() for p in ref.params]
    gen = torch.Generator(device).manual_seed(int(seed) * 1000)
    losses, first = [], None
    for batch in batches[:n_steps]:
        loss, grads = ref.step(batch, gen)
        losses.append(loss)
        if first is None:
            first = {n: float(g.norm()) for n, g in zip(ref.names, grads)}
    change = {n: float((p.detach() - b).norm()) for n, p, b in zip(ref.names, ref.params, before)}
    return dict(losses=losses, grad_norms=first, change_norms=change)
