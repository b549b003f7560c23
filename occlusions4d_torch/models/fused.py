'''
Kernel path of the implicit decoder (port of occlusions4d_tpu/models/fused.py).

fused_field_apply re-expresses LocalImplicitField.forward (attention mode)
over the module's own weights with one shared kNN extraction (kNN kernel),
the interpolation kernel and the attention kernel per cross-attention block.
The backbone's Linear layers stay plain matmuls, as they stay XLA dots in the
JAX package. On CPU tensors every operator runs its plain version.

Two routes, as in the JAX package. Below SHARED_GATHER_MIN_M abstract points
(gv1's 531) every consumer reads its neighbours through the kNN indices
(csrc/interp.cu, csrc/attn.cu in the mode use_premul picks). At or above it
(cv1's 2124) the neighbours' raw [feats | pos] rows are gathered once
(csrc/gather.cu) and the interpolation and both attention layers read them
(o4d_interp_g, o4d_attn_g, per-row projections); the gather and the
interpolation are one operator (knn_gather_interp). The CPU takes the same
route through the plain versions. The threshold is copied from the TPU
(module global, so tests can lower it) until it is re-measured on the H100.

The path is differentiable (the train step's decoder): the operators are
autograd Functions; the attention weights reach them as tensors, so their
gradients flow back to the nn.Linear parameters, and the premul projection
stays outside the kernel, so autograd chains d(kv) to the abstract features
and to_k/to_v. The kNN graph and the abstract positions carry no gradient
(as the JAX path's stop_gradient). Both routes have backward kernels: the
index route csrc/interp_bwd.cu and csrc/attn_bwd.cu; the shared-gather route
o4d_attn_g_bwd (each layer writes its cotangent of the gathered rows),
o4d_scatter (one scatter of their sum to the key rows) and o4d_interp_bwd
(the interpolation's term, from its (B, N, E) cotangent, never written as
rows).

compute_dtype=torch.bfloat16 (the engine's precision='fast', the train
step's fused_decoder_dtype='bf16', JAX's fused_field_apply(compute_dtype=
jnp.bfloat16)): the three operators run their bf16 mode, forward and
backward (the bf16 kernels on CUDA; ops/attention.py says what each product
rounds). What each product gets on CUDA:
  * the operators' own products, forward and backward: bf16 operands, f32
    sums (the kernels do not consult PyTorch's precision setting, and the
    plain versions' bf16-mode operands are bf16 values, exact in TF32);
  * the backbone's nn.Linear layers (lin_in, lin_z, the ResNet blocks,
    layer1, to_q, layer3, lin_out) and premul mode's key projection
    [feats2 Wk | feats2 Wv] (JAX's k_all / v_all, computed in its wrapper
    beside the backbone): plain large products that JAX leaves to XLA at its
    default precision (one bf16 pass on its TPU), forward and backward. Here
    TF32, in both directions: the forward runs in one scope that sets TF32
    for float32 matrix products and restores the global setting on exit;
    the backward reaches two identity autograd nodes around the decoder
    (_Tf32Begin on its outputs, _Tf32End on its differentiable inputs), the
    first of which sets TF32 and the second, whose backward runs after
    every other node of the decoder's (its lowest sequence number), restores
    the setting, so the encoder's backward stays f32.
On the CPU everything stays f32, as JAX's does there. The kNN extraction
stays f32 in every mode.

A decoder built in bf16 (TrainConfig.mixed_precision) is read here in f32,
as the JAX fused_field_apply reads its parameter tree with plain f32 dots
whatever the module's dtype: its Dense layers are applied with their f32
weights (_linear), not through their bf16 forward. The bf16 encoder's
outputs are promoted on entry: the abstract cloud's positions and features
and the global embedding as f32 values of the bf16 ones (JAX's knn_extract
casts the positions to f32; bf16 features meeting f32 kernels promote),
their cotangents rounded to bf16 on the way back by the casts' backward.
'''

import contextlib

import torch
from torch.nn import functional as F

from ..ops.attention import (fused_knn_interp, fused_knn_vector_attention, knn_extract,
                             knn_gather_interp)
from .implicit import BASE_FREQUENCY, activation, positional_encode

__all__ = ['fused_field_apply', 'supports_fused', 'SHARED_GATHER_MIN_M']

SHARED_GATHER_MIN_M = 1024


def supports_fused(decoder):
    '''The fused path covers the shipped decoder configuration.'''
    return (decoder.local_mode == 'attention' and decoder.num_local_features > 0
            and decoder.cross_attn_neighbors <= 32
            and decoder.num_local_features <= 32
            and all(c == 'c' for c in
                    decoder.cr_attn_type[:decoder.cross_attn_layers]))


@contextlib.contextmanager
def _tf32_matmul():
    '''TF32 for the float32 matrix products inside, the global setting
    restored on exit.'''
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('high')
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


class _Tf32Scope:
    '''The precision setting a decoder's backward found on entry.'''

    def __init__(self):
        self.prev = None

    def enter(self):
        if self.prev is None:
            self.prev = torch.get_float32_matmul_precision()
            torch.set_float32_matmul_precision('high')

    def leave(self):
        if self.prev is not None:
            torch.set_float32_matmul_precision(self.prev)
            self.prev = None


class _Tf32Begin(torch.autograd.Function):
    '''Identity on the decoder's outputs; its backward, the first of the
    decoder's, sets TF32 (restored by _Tf32End, or at the end of the
    backward pass if no decoder input needs a gradient).'''

    @staticmethod
    def forward(ctx, scope, *xs):
        ctx.scope = scope
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.scope.enter()
        torch.autograd.Variable._execution_engine.queue_callback(ctx.scope.leave)
        return (None,) + gs


class _Tf32End(torch.autograd.Function):
    '''Identity on the decoder's differentiable inputs; its backward, the
    last of the decoder's, restores the precision setting.'''

    @staticmethod
    def forward(ctx, scope, *xs):
        ctx.scope = scope
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.scope.leave()
        return (None,) + gs


def fused_field_apply(decoder, points_query, pcl_abstract, features_global,
                      abstract_mask=None, compute_dtype=torch.float32):
    '''
    :param decoder: LocalImplicitField (weights and static configuration).
    :param points_query (B, N, 4); pcl_abstract (B, M, 3 + E);
        features_global (B, D); abstract_mask (B, M) bool or None.
    :param compute_dtype: torch.float32, or torch.bfloat16 (the operators'
        bf16 mode, forward and backward, and, on CUDA, the backbone and the
        premul key projection in TF32 in both directions).
    :return (output (B, N, d_out), penult (B, N, d_hidden)), float32.
    '''
    if not supports_fused(decoder):
        raise NotImplementedError('configuration not covered by the fused path')
    pcl_abstract = pcl_abstract.to(torch.float32)
    features_global = features_global.to(torch.float32)
    if not (compute_dtype == torch.bfloat16 and points_query.is_cuda):
        return _field_apply(decoder, points_query, pcl_abstract, features_global,
                            abstract_mask, compute_dtype)
    scope = _Tf32Scope()
    if torch.is_grad_enabled():
        pcl_abstract, features_global = _Tf32End.apply(scope, pcl_abstract, features_global)
    with _tf32_matmul():
        out = _field_apply(decoder, points_query, pcl_abstract, features_global,
                           abstract_mask, compute_dtype)
    if torch.is_grad_enabled():
        out = _Tf32Begin.apply(scope, *out)
    return out


def _linear(m, x):
    '''A Dense layer of the decoder applied in f32, whatever its dtype.'''
    return F.linear(x, m.weight, m.bias)


def _resnet_block(blk, x):
    '''ResnetBlockFC.forward with _linear.'''
    net = _linear(blk.fc_0, blk.act(x))
    dx = _linear(blk.fc_1, blk.act(net))
    xs = x if blk.shortcut is None else _linear(blk.shortcut, x)
    return xs + dx


def _field_apply(decoder, points_query, pcl_abstract, features_global, abstract_mask,
                 compute_dtype):
    act = activation(decoder.activation)
    pts_abs = pcl_abstract[..., :3]
    feats_abs = pcl_abstract[..., 3:]
    B, N, _ = points_query.shape
    q_xyz = points_query[..., :3]

    # One exact kNN extraction feeds the interpolation and every attention
    # layer; each reads the prefix of its own k.
    k_ext = max(decoder.cross_attn_neighbors if decoder.use_pt_inds else 0,
                decoder.num_local_features)
    knn = knn_extract(q_xyz, pts_abs, k_ext, key_mask=abstract_mask)
    # Large abstract clouds: gather the neighbours' raw rows once for every
    # consumer (the JAX package's shared-gather route); the interpolation
    # reads them inside the same operator, whose backward adds its term
    # through the index route's interp_bwd, never as dense row cotangents.
    gathered = None
    if pts_abs.shape[1] >= SHARED_GATHER_MIN_M:
        gathered, features_local = knn_gather_interp(
            pts_abs, feats_abs, knn, k_ext, decoder.num_local_features, eps=1e-4,
            compute_dtype=compute_dtype)
    else:
        features_local = fused_knn_interp(q_xyz, pts_abs, feats_abs,
                                          decoder.num_local_features, eps=1e-4,
                                          key_mask=abstract_mask, knn=knn,
                                          compute_dtype=compute_dtype)
    fg = features_global[:, None, :].expand(B, N, features_global.shape[-1])
    features_query = torch.cat([fg, features_local], dim=-1)

    enc = points_query
    if decoder.pos_encoding_freqs > 0:
        enc = positional_encode(enc, BASE_FREQUENCY, decoder.pos_encoding_freqs)
    x = _linear(decoder.lin_in, enc)
    use_pt = decoder.use_pt_inds
    for i in range(decoder.n_blocks):
        x = x + _linear(decoder.lin_z[i], features_query)
        x = _resnet_block(decoder.blocks[i], x)
        if i in use_pt:
            blk = decoder.pt_blocks[use_pt[i]]
            att = blk.layer2
            q_proj = _linear(att.to_q, _linear(blk.layer1, x))
            y = fused_knn_vector_attention(
                q_proj, q_xyz, feats_abs, pts_abs, att.kernel_params(),
                decoder.cross_attn_neighbors, key_mask=abstract_mask, knn=knn,
                gathered=gathered, compute_dtype=compute_dtype)
            x = x + _linear(blk.layer3, y)
    return _linear(decoder.lin_out, act(x)), x
