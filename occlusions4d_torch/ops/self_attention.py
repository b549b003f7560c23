'''
The encoder's fused gathered self-attention (port of
occlusions4d_tpu/ops/pallas_self_attention.py, `fused_gathered_attention`).

One PointTransformer self-attention block over neighbour rows gathered before
the call: per query n and neighbour j, with gf[n, j] the neighbour's RAW
features and rel[n, j] = pos_n - pos_neighbour,
  k = gf Wk, v = gf Wv                       (bias-free, applied per row)
  theta = W2 relu(W1 rel + b1) + b2          (3 -> P -> D)
  l = (A2 relu(A1 (q_n - k + theta) + c1) + c2) / sqrt(D)      (D -> 2D -> D)
  out_n = sum_j e_j (v_j + theta_j) / sum_j e_j, e_j = exp(l_j - max_j l_j)
with the softmax per channel over the K neighbours.

`fused_gathered_attention` is a torch.autograd.Function: on CUDA tensors the
forward runs o4d_sattn (csrc/attn.cu, the decoder's forward pipeline over
gf and rel as given) and the backward o4d_sattn_bwd (csrc/attn_bwd.cu); on
CPU tensors the plain versions below, which spell out the kernels' formulas
(pallas_self_attention.py:159-214), not autograd of a chain. Gradients reach q, gf and the ten weight tensors; rel is a constant
(the module stop-gradients the positions), as in the JAX custom VJP. Like it,
the operator saves only its inputs.

compute_dtype=torch.bfloat16 (the encoder under TrainConfig.mixed_precision,
JAX's compute_dtype=jnp.bfloat16): o4d_sattn_bf16 and o4d_sattn_bwd_bf16 on
CUDA. The TPU kernels' _mm / _mm2 (pallas_attention.py:66-75) round both
operands of every product to bf16 and sum in f32, the products that decide
a ReLU (rel W1, hpre A1) included; the softmax, v + theta and the output
sums stay f32. As the JAX wrapper and custom VJP (pallas_self_attention.py:
298-368) cast: gf and the weight kernels are rounded to bf16 before the call
(so their gradients, through the casts, are bf16 values too), q, rel and
the biases stay f32; the backward rounds dgf and the weight kernels'
gradients to bf16 and leaves dq and the biases' gradients f32 (the module's
cast of its bf16 q projection rounds dq). The plain bf16 versions spell
that out (never autograd through the rounded forward, which would leave the
cotangent operands unrounded).
'''

import ctypes
import math

import torch

from . import _build
from .attention import (_attn_bwd_lib, _attn_lib, _bwd_plan, _cuda_f32, _fwd_plan,
                        _grad_names, _is_bf16, _params, _rounder, _split_weight_grads,
                        _weight_operands, _weight_ptrs, round_bf16)

__all__ = ['fused_gathered_attention', 'sattn_plain', 'sattn_bwd_plain', 'sattn_bwd',
           'LAUNCHES']

LAUNCHES = {'sattn': 0, 'sattn_bwd': 0, 'sattn_bf16': 0, 'sattn_bwd_bf16': 0}


def _w(params, name):
    return params[name]['kernel'].to(torch.float32)


def _b(params, name):
    return params[name]['bias'].to(torch.float32)


def _forward_parts(q, gf, rel, params, r):
    '''The recomputed forward of the backward kernel (:159-180): every
    per-row tensor the gradient chain reads; r rounds each product's
    operands (bf16) or is the identity (f32).'''
    kg = r(gf) @ r(_w(params, 'to_k'))                            # (B, N, K, D).
    vg = r(gf) @ r(_w(params, 'to_v'))
    ph_pre = r(rel) @ r(_w(params, 'pos_mlp_0')) + _b(params, 'pos_mlp_0')
    ph = torch.relu(ph_pre)                                       # (B, N, K, P).
    pe = r(ph) @ r(_w(params, 'pos_mlp_2')) + _b(params, 'pos_mlp_2')
    hpre = (q[:, :, None, :] - kg) + pe
    h1 = r(hpre) @ r(_w(params, 'attn_mlp_0')) + _b(params, 'attn_mlp_0')  # (B, N, K, H).
    h1r = torch.relu(h1)
    lg = (r(h1r) @ r(_w(params, 'attn_mlp_2')) + _b(params, 'attn_mlp_2')) \
        * (1.0 / math.sqrt(q.shape[-1]))
    e = torch.exp(lg - lg.amax(dim=2, keepdim=True))
    return dict(ph_pre=ph_pre, ph=ph, vpe=vg + pe, hpre=hpre, h1=h1, h1r=h1r, e=e,
                den=e.sum(dim=2, keepdim=True))


def sattn_plain(q, gf, rel, params, compute_dtype=torch.float32):
    '''Plain version of the forward kernel (:56-92); bf16: of
    o4d_sattn_bf16, every product's operands rounded to bf16.
    :param q (B, N, D); gf (B, N, K, E); rel (B, N, K, 3); params: the JAX
        layout ({'to_k': {'kernel' (E, D)}, ..., 'attn_mlp_2': {'kernel',
        'bias'}}). :return (B, N, D) f32.'''
    f = _forward_parts(q, gf, rel, params, _rounder(_is_bf16(compute_dtype)))
    return (f['e'] * f['vpe']).sum(dim=2) / f['den'][:, :, 0]


def sattn_bwd_plain(q, gf, rel, params, go, compute_dtype=torch.float32):
    '''Plain version of the backward kernel, its formulas (:182-214) over
    whole tensors; bf16: of o4d_sattn_bwd_bf16, every product's operands
    rounded to bf16 (_mm2), then dgf and the weight kernels' gradients
    rounded to bf16 (the custom VJP's casts, :317-368), dq and the biases'
    gradients f32. :return (dq (B, N, D), dgf (B, N, K, E), {(name, leaf):
    d(weight)}) in the layout of the forward's params.'''
    bf16 = _is_bf16(compute_dtype)
    r = _rounder(bf16)
    with torch.no_grad():
        f = _forward_parts(q, gf, rel, params, r)
        inv_sqrt_d = 1.0 / math.sqrt(q.shape[-1])
        a = f['e'] / f['den']                                     # (B, N, K, D).
        g3 = go.to(torch.float32)[:, :, None, :]
        dvpe = a * g3
        da = g3 * f['vpe']
        s = (a * da).sum(dim=2, keepdim=True)
        dmlp = a * (da - s) * inv_sqrt_d

        def outer(x, y):  # sum over every row of x_r^T y_r.
            return r(x.reshape(-1, x.shape[-1])).T @ r(y.reshape(-1, y.shape[-1]))

        def colsum(x):
            return x.reshape(-1, x.shape[-1]).sum(0)

        def wt(name):
            return r(_w(params, name)).T
        dh1 = torch.where(f['h1'] > 0, r(dmlp) @ wt('attn_mlp_2'), 0.0)
        dhpre = r(dh1) @ wt('attn_mlp_0')
        dpe = dhpre + dvpe
        dph = torch.where(f['ph_pre'] > 0, r(dpe) @ wt('pos_mlp_2'), 0.0)
        dk = -dhpre
        grads = {('to_k', 'kernel'): outer(gf, dk), ('to_v', 'kernel'): outer(gf, dvpe),
                 ('pos_mlp_0', 'kernel'): outer(rel, dph), ('pos_mlp_0', 'bias'): colsum(dph),
                 ('pos_mlp_2', 'kernel'): outer(f['ph'], dpe),
                 ('pos_mlp_2', 'bias'): colsum(dpe),
                 ('attn_mlp_0', 'kernel'): outer(f['hpre'], dh1),
                 ('attn_mlp_0', 'bias'): colsum(dh1),
                 ('attn_mlp_2', 'kernel'): outer(f['h1r'], dmlp),
                 ('attn_mlp_2', 'bias'): colsum(dmlp)}
        dgf = r(dk) @ wt('to_k') + r(dvpe) @ wt('to_v')
        if bf16:
            dgf = round_bf16(dgf)
            grads = {nl: round_bf16(v) if nl[1] == 'kernel' else v
                     for nl, v in grads.items()}
        return dhpre.sum(dim=2), dgf, grads


def _operands(q, gf, rel, params, k, bf16):
    '''Checked shapes and contiguous weights shared by both kernels (bf16:
    the weight kernels rounded to bf16).'''
    B, N, D = q.shape
    E = gf.shape[-1]
    if tuple(gf.shape) != (B, N, k, E) or tuple(rel.shape) != (B, N, k, 3) \
            or not 1 <= k <= 32:
        raise ValueError(f'sattn: gf {tuple(gf.shape)}, rel {tuple(rel.shape)} do not '
                         f'fit q {tuple(q.shape)}, k={k}')
    w, b, wk, wv, H, P = _weight_operands(params, D, E, False, bf16=bf16)
    for name, t in (('q', q), ('gf', gf), ('rel', rel)):
        _cuda_f32(name, t)
    return B, N, D, E, H, P, [wk, wv] + _weight_ptrs(w, b)


def _sattn_cuda(q, gf, rel, params, k, bf16=False):
    B, N, D, E, H, P, weights = _operands(q, gf, rel, params, k, bf16)
    lib = _attn_lib()
    QC, ws = _fwd_plan(lib, 'sattn', q.device, N, D, E, H, P, k, False, self_rows=True)
    out = torch.empty((B, N, D), dtype=torch.float32, device=q.device)
    name = 'sattn_bf16' if bf16 else 'sattn'
    fn = getattr(lib, f'o4d_{name}')
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device), _build.span(name):
        _build.check(fn(*[_build.ptr(t) for t in [q, gf, rel] + weights + [out, ws]],
                        B, N, D, E, H, P, k, QC, _build.stream_ptr(q.device)), name)
    _build.count_launch(LAUNCHES, name)
    return out


def _sattn_bwd_cuda(q, gf, rel, params, k, go, bf16=False):
    B, N, D, E, H, P, weights = _operands(q, gf, rel, params, k, bf16)
    _cuda_f32('go', go)
    if tuple(go.shape) != (B, N, D):
        raise ValueError(f'sattn_bwd: go {tuple(go.shape)} does not fit {(B, N, D)}')
    lib = _attn_bwd_lib()
    n_w = lib.o4d_attn_bwd_weight_floats(D, E, H, P, 0)
    dev = q.device
    QC, ws, _ = _bwd_plan(lib, dev, N, 0, D, E, H, P, k, False)
    dq = torch.empty((B, N, D), dtype=torch.float32, device=dev)
    dw = torch.empty((n_w,), dtype=torch.float32, device=dev)
    dgf = torch.empty(gf.shape, dtype=torch.float32, device=dev)
    name = 'sattn_bwd_bf16' if bf16 else 'sattn_bwd'
    fn = getattr(lib, f'o4d_{name}')
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = [q, gf, rel] + weights + [go, dq, dw, dgf, ws]
    with torch.cuda.device(dev), _build.span(name):
        _build.check(fn(*[_build.ptr(t) for t in ptrs], B, N, D, E, H, P, k, QC,
                        _build.stream_ptr(dev)), name)
    _build.count_launch(LAUNCHES, name)
    return dq, dgf, _split_weight_grads(dw, D, E, H, P, False)


def sattn_bwd(q, gf, rel, params, k, go, compute_dtype=torch.float32):
    '''Backward of the operator: its kernel (bf16: o4d_sattn_bwd_bf16) on
    CUDA, the plain version on the CPU.
    :return (dq, dgf, {(name, leaf): d(weight)}).'''
    go = go.to(torch.float32).contiguous()
    if q.is_cuda:
        return _sattn_bwd_cuda(q, gf, rel, params, k, go, _is_bf16(compute_dtype))
    return sattn_bwd_plain(q, gf, rel, params, go, compute_dtype)


class _SelfAttention(torch.autograd.Function):
    '''Forward o4d_sattn, backward o4d_sattn_bwd (bf16: o4d_sattn_bf16,
    o4d_sattn_bwd_bf16; plain versions on the CPU). Saves only its inputs;
    rel gets no gradient.'''

    @staticmethod
    def forward(ctx, q, gf, rel, k, cd, *weights):
        names = _grad_names(False)
        ctx.save_for_backward(q, gf, rel, *weights)
        ctx.k, ctx.names, ctx.cd = k, names, cd
        params = _params(names, weights)
        if q.is_cuda:
            return _sattn_cuda(q, gf, rel, params, k, _is_bf16(cd))
        return sattn_plain(q, gf, rel, params, cd)

    @staticmethod
    def backward(ctx, go):
        q, gf, rel, *weights = ctx.saved_tensors
        dq, dgf, dws = sattn_bwd(q, gf, rel, _params(ctx.names, weights), ctx.k, go,
                                 ctx.cd)
        return (dq, dgf, None, None, None) + tuple(dws[nl] for nl in ctx.names)


def fused_gathered_attention(q_proj, gathered_feats, rel, params, k,
                             compute_dtype=torch.float32):
    '''
    One fused vector self-attention block over pre-gathered neighbours.
    :param q_proj (B, N, D): projected queries (to_q applied).
    :param gathered_feats (B, N, K, E): RAW neighbour features (differentiable).
    :param rel (B, N, K, 3): coordinate deltas pos_q - pos_neighbour (a
        constant).
    :param params: {'to_k', 'to_v' (bias-free), 'pos_mlp_0', 'pos_mlp_2',
        'attn_mlp_0', 'attn_mlp_2'}, each {'kernel' (in, out), ['bias']}.
    :param k (int): neighbours, K; 1 to 32 (the kernels' limit).
    :param compute_dtype: torch.float32, or torch.bfloat16 (the kernels'
        bf16 mode; gf and the weight kernels rounded to bf16 here, as the
        JAX wrapper casts them, so that their gradients are rounded too).
    :return (B, N, D) float32.
    '''
    if gathered_feats.shape[2] != k:
        raise ValueError(f'gathered_feats {tuple(gathered_feats.shape)} does not hold '
                         f'k={k} neighbours')
    r = _rounder(_is_bf16(compute_dtype))
    weights = [params[n][leaf].to(torch.float32) for n, leaf in _grad_names(False)]
    weights = [r(w) if leaf == 'kernel' else w
               for (_, leaf), w in zip(_grad_names(False), weights)]
    return _SelfAttention.apply(q_proj.to(torch.float32).contiguous(),
                                r(gathered_feats.to(torch.float32)).contiguous(),
                                rel.detach().to(torch.float32).contiguous(), int(k),
                                compute_dtype, *weights)
