'''
Point-transformer building blocks (port of occlusions4d_tpu/models/layers.py).

Attribute names follow the reference torch layout that the JAX package's
export_torch_state_dict emits (`layer2.pos_mlp.0.weight`, `mlp.1.weight`),
so checkpoint.from_jax_params output loads with strict=True.

VectorAttention has two paths over the same parameters, chosen as the JAX
module chooses them (its `fused` flag):
  * the plain PyTorch chain (kNN graph, gathers, theta/gamma MLPs,
    per-channel softmax), taken by cross attention, by a key mask, by K not a
    multiple of 8, and by fused 'auto' / 'off'. The inference engine runs it,
    as the JAX engine forces its XLA chain (fused_attention='off');
  * the fused self-attention operator (ops/self_attention.py: o4d_sattn
    forward and o4d_sattn_bwd backward on CUDA) over the neighbours' raw
    features, gathered by the gather kernel and scattered back by its
    scatter (ops/attention.py::gather_rows), with fused 'on'.
Both take their kNN graph from ops.knn, hence from the kNN kernels on CUDA.

Every module takes a dtype (torch.float32 or torch.bfloat16, the JAX
package's `dtype`, bf16 under TrainConfig.mixed_precision), with flax's rule
rather than torch.autocast's: each linear layer (Dense) casts its input,
weight and bias to the dtype and returns the dtype, the parameters staying
f32, so that autograd through the casts gives f32 gradients holding
bf16-rounded values, as JAX's transpose of astype does; layer norm computes
in f32 and returns the dtype. Positions stay f32 through FPS and the kNN;
only features take the dtype.
'''

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops import fps_batched, gather_neighbors, knn, knn_interpolate
from ..ops.attention import gather_rows
from ..ops.self_attention import fused_gathered_attention
from ..parallel import AllReduceSum, host_sum

__all__ = ['Dense', 'NormLayer', 'set_norm_group', 'take_batch_stats', 'commit_batch_stats',
           'VectorAttention', 'PointTransformerBlock', 'DownTransition', 'UpTransition']


class Dense(nn.Linear):
    '''nn.Linear computing in `dtype` as flax's nn.Dense(dtype=...): input,
    weight and bias cast to dtype, the product then the bias added, each
    result in dtype; the parameters stay f32. In f32 it is nn.Linear.'''

    def __init__(self, d_in, d_out, bias=True, dtype=torch.float32):
        super().__init__(d_in, d_out, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        if dt == torch.float32:
            return F.linear(x.to(dt), self.weight, self.bias)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


# XLA's CPU compiler splits a reduction longer than 32 into windows of 32
# (the reduced axis zero-padded to a multiple of 32, half the padding in
# front), each summed in order from zero, and repeats on the window sums
# (TreeReductionRewriter). _xla_row_sum sums in that order, so batch
# statistics here lose the digits the JAX package's lose.
_XLA_WINDOW = 32


def _xla_row_sum(x):
    '''Sum of a (R, D) tensor over its rows, in XLA's CPU order.'''
    while x.shape[0] > _XLA_WINDOW:
        R = x.shape[0]
        P = -(-R // _XLA_WINDOW) * _XLA_WINDOW
        front = (P - R) // 2
        w = F.pad(x, (0, 0, front, P - R - front)).view(P // _XLA_WINDOW, _XLA_WINDOW, -1)
        x = _ordered_sum(w.unbind(1))
    return _ordered_sum(x.unbind(0))


def _ordered_sum(parts):
    # unbind, not indexing: its backward is one stack, not a scatter a part.
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


class NormLayer(nn.Module):
    '''none / batch / layer (eps 1e-5). Parameters sit on the module itself,
    as the reference's nn.BatchNorm1d/LayerNorm.

    batch is flax's BatchNorm as the JAX package configures it (momentum 0.9,
    eps 1e-3, use_fast_variance), not torch's BatchNorm1d. In eval mode it
    normalises with the running statistics. In train mode it normalises with
    the batch's: over the flattened (B*N) axis in f32, mean E[x] and biased
    variance max(E[x^2] - E[x]^2, 0), the sums in XLA's CPU order
    (_xla_row_sum) scaled by 1/(B*N), the difference as the JAX program
    compiled by XLA for the CPU takes it (an fma where it normalises, two
    rounded operations for the running variance; at a mean far from zero
    the two keep different digits). The running statistics' update,
    0.9 r + 0.1 batch (the biased variance), is not applied here: the forward
    leaves it in `pending` (detached), and the train step commits it after
    the optimizer step, or drops it (take_batch_stats, commit_batch_stats),
    as the JAX train step merges the mutated batch_stats collection.'''

    def __init__(self, norm_type, dim, dtype=torch.float32):
        super().__init__()
        if norm_type not in ('none', 'batch', 'layer'):
            raise ValueError(norm_type)
        self.norm_type = norm_type
        self.dim = dim
        self.dtype = dtype
        self.pending = None
        self.group = None      # set_norm_group: batch statistics over a group.
        if norm_type != 'none':
            self.weight = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))
        if norm_type == 'batch':
            self.register_buffer('running_mean', torch.zeros(dim))
            self.register_buffer('running_var', torch.ones(dim))

    def forward(self, x):
        '''Statistics and arithmetic in f32 (flax's normalisation layers
        promote to f32), the result in the module's dtype.'''
        if self.norm_type == 'none':
            return x
        x32 = x.to(torch.float32)
        if self.norm_type == 'layer':
            return F.layer_norm(x32, (self.dim,), self.weight, self.bias,
                                eps=1e-5).to(self.dtype)
        if self.training:
            rows = x32.reshape(-1, self.dim)
            s, s2 = _xla_row_sum(rows), _xla_row_sum(rows * rows)
            n_rows = rows.shape[0]
            if self.group is not None:
                # The global batch's statistics, as flax's BatchNorm under a
                # sharded jit takes them: each rank's sums added over the
                # group, with a backward that adds their gradients too.
                s, s2 = AllReduceSum.apply(torch.stack([s, s2])).unbind(0)
                n_rows = host_sum(n_rows, self.group)
            scale = float(np.float32(1.0 / n_rows))
            mean = s * scale
            mean_sq = mean * mean
            # Where it normalises, XLA computes E[x^2] - E[x]^2 as
            # fma(sum x^2, 1/R, -E[x]^2), a difference that keeps digits the
            # rounded product loses: the f64 product is exact, so this is
            # the fma's result (but for a rare double rounding).
            var = torch.clamp_min((s2.double() * scale - mean_sq.double()).to(torch.float32),
                                  0.0)
            # The running variance takes the two rounded operations, the
            # running mean XLA's folded constant: 0.9 r + sum x (0.1 / R).
            var_run = torch.clamp_min(s2.detach() * scale - mean_sq.detach(), 0.0)
            self.pending = (
                0.9 * self.running_mean + s.detach() * float(np.float32(0.1) * np.float32(scale)),
                0.9 * self.running_var + 0.1 * var_run)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + 1e-3)
        y = (x32 - mean) * (inv * self.weight) + self.bias
        return y.to(self.dtype)


def set_norm_group(module, group):
    '''Make every batch-norm layer of `module` take its train-mode statistics
    over a data-parallel group (parallel.Group: each rank's rows summed over
    the ranks), or over its own rows again with None.'''
    for m in module.modules():
        if isinstance(m, NormLayer):
            m.group = group


def take_batch_stats(module):
    '''The running statistics the last train-mode forward of `module`'s
    batch-norm layers left pending, each taken (the layer's pending cleared).
    :return [(layer, new running_mean, new running_var)], empty without
        batch norm.'''
    out = []
    for m in module.modules():
        if isinstance(m, NormLayer) and m.pending is not None:
            out.append((m, *m.pending))
            m.pending = None
    return out


@torch.no_grad()
def commit_batch_stats(updates, keep=None):
    '''Write take_batch_stats' updates into the layers' running statistics;
    where the bool tensor `keep` is False the old ones stay (the train
    step's skip of a non-finite gradient).'''
    for layer, mean, var in updates:
        if keep is not None:
            mean = torch.where(keep, mean, layer.running_mean)
            var = torch.where(keep, var, layer.running_var)
        layer.running_mean.copy_(mean)
        layer.running_var.copy_(var)


def _softmax(a, dim):
    '''jax.nn.softmax in a's dtype, each operation rounded to it as the JAX
    program rounds it (torch.softmax of a bf16 tensor rounds once, after an
    f32 computation): exp(a - max) / sum, the max held constant.'''
    e = torch.exp(a - a.amax(dim, keepdim=True).detach())
    return e / e.sum(dim, keepdim=True)


def _mlp(d_in, d_hidden, d_out, dtype):
    return nn.Sequential(Dense(d_in, d_hidden, dtype=dtype), nn.ReLU(),
                         Dense(d_hidden, d_out, dtype=dtype))


class VectorAttention(nn.Module):
    '''attn = softmax_K(gamma(q - k + theta(dp)) / sqrt(dim));
    out = sum_K attn * (v + theta).

    fused ('auto'|'on'|'off'): 'on' runs the fused self-attention operator
    when the call is self attention without a key mask and num_neighbors is
    a multiple of 8 (the JAX rule, occlusions4d_tpu/models/layers.py:142-156);
    every other case, and 'auto' and 'off', runs the chain.

    dtype bf16 (JAX layers.py:142-173): the chain casts rel to bf16 and runs
    q - k + theta, the softmax over K (of the logits over sqrt(dim) rounded
    to bf16, JAX's jnp.sqrt of a bf16 dim) and the final sum on bf16
    operands; the fused path hands the operator the bf16 q projection as
    f32 values, the gathered bf16 features and the f32, unrounded rel, in
    its bf16 compute mode, and casts its output to bf16.'''

    def __init__(self, dim, d_query=None, dim2=None, num_neighbors=16,
                 pos_mlp_hidden_dim=32, attn_mlp_hidden_mult=2, fused='auto',
                 dtype=torch.float32):
        super().__init__()
        if fused not in ('auto', 'on', 'off'):
            raise ValueError(f'fused={fused!r}')
        self.dim = dim
        self.num_neighbors = num_neighbors
        self.fused = fused
        self.dtype = dtype
        self.to_q = Dense(d_query or dim, dim, bias=False, dtype=dtype)
        self.to_k = Dense(dim2 or dim, dim, bias=False, dtype=dtype)
        self.to_v = Dense(dim2 or dim, dim, bias=False, dtype=dtype)
        self.pos_mlp = _mlp(3, pos_mlp_hidden_dim, dim, dtype)
        self.attn_mlp = _mlp(dim, dim * attn_mlp_hidden_mult, dim, dtype)

    def kernel_params(self):
        '''The weights in the JAX layout the fused operators take:
        {name: {'kernel' (in, out), ['bias']}} (views of the parameters).'''
        def lin(m):
            p = {'kernel': m.weight.t()}
            if m.bias is not None:
                p['bias'] = m.bias
            return p
        return {'to_k': lin(self.to_k), 'to_v': lin(self.to_v),
                'pos_mlp_0': lin(self.pos_mlp[0]), 'pos_mlp_2': lin(self.pos_mlp[2]),
                'attn_mlp_0': lin(self.attn_mlp[0]), 'attn_mlp_2': lin(self.attn_mlp[2])}

    def forward(self, x, pos, x2=None, pos2=None, key_mask=None):
        '''x (B, N, D), pos (B, N, 3); x2 (B, M, D2), pos2 (B, M, 3) for cross
        attention (None: self attention); key_mask (B, M) bool or None.'''
        self_attention = x2 is None
        # Positions carry no gradient (JAX's stop_gradient of both sets).
        pos = pos.detach()
        pos2 = pos if self_attention else pos2.detach()
        if self_attention:
            x2 = x
        # The same object as query and key set lets the pruned kNN sort once.
        _, idx = knn(pos, pos2, self.num_neighbors, key_mask=key_mask)
        knn_xyz = gather_neighbors(pos2[..., :3], idx)
        q = self.to_q(x)
        dt = self.dtype
        if (self.fused == 'on' and self_attention and key_mask is None
                and self.num_neighbors % 8 == 0):
            gf = gather_rows(x2.to(dt), idx)                            # (B, N, K, E).
            rel = pos[..., None, :3] - knn_xyz                          # (B, N, K, 3).
            out = fused_gathered_attention(q, gf, rel.detach(), self.kernel_params(),
                                           self.num_neighbors, compute_dtype=dt)
            return out.to(dt)
        k = gather_neighbors(self.to_k(x2), idx)
        v = gather_neighbors(self.to_v(x2), idx)
        pe = self.pos_mlp((pos[..., None, :3] - knn_xyz).to(dt))
        a = self.attn_mlp(q[..., None, :] - k + pe)
        if dt == torch.float32:
            attn = torch.softmax(a / math.sqrt(self.dim), dim=-2)
        else:
            attn = _softmax(a / torch.sqrt(torch.tensor(float(self.dim), dtype=dt)), -2)
        return torch.einsum('bnkd,bnkd->bnd', attn, v + pe)


class PointTransformerBlock(nn.Module):
    '''Linear -> vector attention -> linear, with residual.'''

    def __init__(self, d_in, d_hidden, d_out, num_neighbors=16,
                 d_hidden_abstract=None, fused='auto', dtype=torch.float32):
        super().__init__()
        self.layer1 = Dense(d_in, d_hidden, dtype=dtype)
        self.layer2 = VectorAttention(d_hidden, dim2=d_hidden_abstract,
                                      num_neighbors=num_neighbors, fused=fused,
                                      dtype=dtype)
        self.layer3 = Dense(d_hidden, d_out, dtype=dtype)

    def forward(self, x, p, x2=None, p2=None, key_mask=None):
        y = self.layer2(self.layer1(x), p, x2=x2, pos2=p2, key_mask=key_mask)
        return x + self.layer3(y), p


class DownTransition(nn.Module):
    '''FPS by 1/factor, per-point MLP, max-pool over the knn_k nearest input
    points of each kept point. Deterministic FPS start 0 unless start_idx is
    given (the training-time random start). Positions stay f32; the
    features take the dtype.'''

    def __init__(self, d_in, d_out, factor=2, knn_k=8, norm_type='none',
                 dtype=torch.float32):
        super().__init__()
        self.factor = factor
        self.knn_k = knn_k
        self.mlp = nn.Sequential(Dense(d_in, d_out, dtype=dtype),
                                 NormLayer(norm_type, d_out, dtype), nn.ReLU())

    def forward(self, x, p, start_idx=None):
        B, N, _ = x.shape
        n_new = -(-N // self.factor)
        sub_idx = fps_batched(p, n_new, start_idx=start_idx)          # (B, n_new).
        p_sub = torch.gather(p, 1, sub_idx[..., None].expand(B, n_new, p.shape[-1]))
        _, nbr = knn(p_sub, p, self.knn_k)
        z = gather_neighbors(self.mlp(x), nbr)
        return z.amax(dim=-2), p_sub


class UpTransition(nn.Module):
    '''Skip-connected upsampling (the encoder's enable_decoder path):
    mlp1(x1) interpolated from the coarse points p1 onto the skip's points
    p2 (inverse-distance weights over the knn_k nearest, eps 1e-7, through
    the kNN kernels on CUDA) plus mlp2(x2). Each MLP is Linear -> NormLayer
    -> ReLU; mlp1 reads d_in channels, mlp2 the skip's d_out.'''

    def __init__(self, d_in, d_out, factor=2, knn_k=3, norm_type='none',
                 dtype=torch.float32):
        super().__init__()
        self.factor = factor
        self.knn_k = knn_k
        self.mlp1 = nn.Sequential(Dense(d_in, d_out, dtype=dtype),
                                  NormLayer(norm_type, d_out, dtype), nn.ReLU())
        self.mlp2 = nn.Sequential(Dense(d_out, d_out, dtype=dtype),
                                  NormLayer(norm_type, d_out, dtype), nn.ReLU())

    def forward(self, x1, p1, x2, p2):
        y1 = self.mlp1(x1)
        y2 = self.mlp2(x2)
        # f32 weights over the features as f32 (JAX's einsum promotes a bf16
        # y1 so); the sum is then f32 too.
        y1_super = knn_interpolate(y1.to(torch.float32), p1.detach(), p2.detach(),
                                   self.knn_k, eps=1e-7)
        return y1_super + y2, p2
