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

import torch
from torch import nn
from torch.nn import functional as F

from ..ops import fps_batched, gather_neighbors, knn
from ..ops.attention import gather_rows
from ..ops.self_attention import fused_gathered_attention

__all__ = ['Dense', 'NormLayer', 'VectorAttention', 'PointTransformerBlock',
           'DownTransition']


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


class NormLayer(nn.Module):
    '''none / batch (eval statistics, eps 1e-3) / layer (eps 1e-5). Parameters
    sit on the module itself, as the reference's nn.BatchNorm1d/LayerNorm.
    Batch norm in train mode (batch statistics, running-average updates) is
    not ported: it raises rather than quietly normalize with the running
    statistics.'''

    def __init__(self, norm_type, dim, dtype=torch.float32):
        super().__init__()
        if norm_type not in ('none', 'batch', 'layer'):
            raise ValueError(norm_type)
        self.norm_type = norm_type
        self.dim = dim
        self.dtype = dtype
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
        if self.norm_type == 'layer':
            return F.layer_norm(x.to(torch.float32), (self.dim,), self.weight, self.bias,
                                eps=1e-5).to(self.dtype)
        if self.training:
            raise NotImplementedError('NormLayer(batch) in train mode (batch '
                                      'statistics) is not ported; call .eval()')
        inv = torch.rsqrt(self.running_var + 1e-3)
        y = (x.to(torch.float32) - self.running_mean) * (inv * self.weight) + self.bias
        return y.to(self.dtype)


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
