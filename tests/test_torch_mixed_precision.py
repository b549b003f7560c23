'''
The port's mixed-precision train step (TrainConfig.mixed_precision: both
networks in bf16 over f32 parameters, AdamW eps 1e-4, the encoder's fused
self-attention in its bf16 mode) held against the JAX package with
dtype=bfloat16 on the CPU. The port runs its kernels' plain bf16 versions
here (sattn_plain / sattn_bwd_plain with compute_dtype=torch.bfloat16,
explicit decompositions); JAX runs its Pallas kernels in interpret mode, as
its own tests run them. Inputs and weights are made with numpy from a seed
and handed to both.

The JAX references are compiled without XLA's excess precision
(xla_allow_excess_precision=False, STRICT): by default XLA's CPU compiler
keeps bf16 intermediates in f32 between fused operations, so its bf16 chain
lands about as far from a program that rounds each operation to bf16 as an
f32 run does. Compiled strictly, each operation rounds, as the port's bf16
tensors do, and the forward passes below agree bit for bit.

Tolerances, each with its reason:
  * the plain bf16 self-attention: the forward within relative L2 1e-4 of
    JAX's (FTOL; both sum exact products of the same bf16 operands in f32,
    in another order; 1e-7 measured), every gradient within 1e-3 (GTOL, as
    tests/test_torch_fast_train.py: an f32 sum that differs by an ulp may
    round to the neighbouring bf16 value; 0 to 1.3e-5 measured), the logits'
    bias, zero in truth, within 1e-5 absolute; the port's f32 versions on
    the same inputs land outside both gates (2.3e-3 forward, 1.3e-3 to
    5.9e-2 per gradient);
  * modules and encoders: the forward within relative L2 1e-3 of JAX's
    strict bf16 (bit-equal measured; the f32 modules 2e-3 to 5e-3 away);
    the fused path's gradients each within 2e-2 (GTOL_ON; bf16 cotangents
    summed in another order: the gather's transpose sums in bf16 in JAX, in
    f32 then rounded once in the port; 1e-7 to 1.2e-2 measured) and as one
    vector within 1e-3 of JAX's for a module, 1.5e-2 for an encoder
    (6e-5 / 3.3e-3 / 6.6e-3 measured), the f32 port's vector outside (2.2e-3
    to 6e-2); the logits' bias, zero in truth, is bf16 rounding
    noise on both sides (up to 2.4e-2 in a module) and is left out;
  * the chain's gradients: each within the JAX package's own bf16 gate,
    3e-2 relative (tests/test_pallas_ops.py:141-180; up to 1.6e-2
    measured), and as one vector within 2e-3 of JAX's (1.5e-3 / 1.6e-3
    measured, the f32 port's 2.5e-3 / 3.5e-3), both but for the biases
    whose gradient sums cancelling terms (the positional MLP's and the
    logits', 5e-2 to 1.7 relative in both modes): XLA rounds the bf16
    backward's reductions in its own order (each bf16 add rounded), the port
    accumulates them in f32. A whole chain encoder, through two max-pools,
    is held as one vector (within 1.5e-2, 5.8e-3 / 8.4e-3 measured, the f32
    port's 2.5e-2 / 6.2e-2; per gradient up to 1.2e-1 in both modes); the
    decoder's module path the same way as a module (2e-2; 3.0e-3 measured,
    the f32 port's 1.2e-1);
  * the lockstep: losses within rtol 1e-2 (bf16 modules on both sides,
    every reduction rounded in its own order) and parameter deltas within
    relative 3e-2 of JAX's after every step (Adam moves each weight by
    about lr x sign(g), so an entry whose gradient is near zero may move
    the other way).
'''

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# Six test workers share eight cores: keep PyTorch's CPU pool small.
torch.set_num_threads(2)

from occlusions4d_tpu.config import TrainConfig as JTrainConfig
from occlusions4d_tpu.models.encoder import PointEncoder as JEncoder
from occlusions4d_tpu.models.implicit import LocalImplicitField as JField
from occlusions4d_tpu.models.layers import VectorAttention as JVectorAttention
from occlusions4d_tpu.ops.pallas_self_attention import fused_gathered_attention as j_fga
from occlusions4d_tpu.pipeline import PipelineConfig as JPipelineConfig
from occlusions4d_tpu.pipeline import TrainPipeline as JTrainPipeline
from occlusions4d_tpu.sampler import SamplerConfig as JSamplerConfig
from occlusions4d_tpu.train import build_optimizer as j_build_optimizer
from occlusions4d_tpu.train import make_train_step as j_make_train_step
from occlusions4d_torch.checkpoint import from_jax_params
from occlusions4d_torch.config import TrainConfig
from occlusions4d_torch.models import LocalImplicitField, PointEncoder, VectorAttention
from occlusions4d_torch.pipeline import PipelineConfig, TrainPipeline
from occlusions4d_torch.sampler import SamplerConfig
from occlusions4d_torch.train import AdamW, Trainer, build_optimizer, make_train_step

from test_torch_sattn import _case, _torch_params
from test_torch_train import _DEC, _ENC, _LWS, _JFixedSampler, _TFixedSampler, _supervision

t_sattn = importlib.import_module('occlusions4d_torch.ops.self_attention')
t_attn = importlib.import_module('occlusions4d_torch.ops.attention')
t_layers = importlib.import_module('occlusions4d_torch.models.layers')

BF = torch.bfloat16
STRICT = {'xla_allow_excess_precision': False}
FTOL = 1e-4
GTOL = 1e-3
GTOL_ON = 2e-2
GTOL_CHAIN = 3e-2
ZERO_ATOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(a):
    return np.asarray(a, np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)  # writable copies.


def _strict(fn, *args):
    '''fn jitted and compiled without excess precision, applied to args.'''
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)(*args)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _zero_grad(name):
    '''The logits' bias: the softmax over the neighbours removes it, so its
    true gradient is zero and both modes give rounding noise.'''
    return 'attn_mlp_2/bias' in name or 'attn_mlp.2.bias' in name


def _cancelling(name):
    '''Bias gradients that sum cancelling terms over every row.'''
    return _zero_grad(name) or 'pos_mlp.0.bias' in name or 'pos_mlp.2.bias' in name


def _dist(g, ref, skip=_zero_grad):
    '''Relative L2 distance of every gradient but the skipped ones (the zero
    ones), as one vector.'''
    names = [n for n in ref if not skip(n)]
    return _rel_l2(np.concatenate([np.ravel(g[n]) for n in names]),
                   np.concatenate([np.ravel(ref[n]) for n in names]))


def _check_grads(port, f32, ref, each_tol, vec_tol, skip=_zero_grad):
    '''Every gradient of `port` (name -> array) but the skipped ones within
    each_tol of `ref`'s, all of them but the zero ones as one vector within
    vec_tol, and, where f32 is given, the f32 port's vector outside vec_tol.'''
    assert set(port) == set(ref)
    for name in ref:
        if not skip(name):
            assert _rel_l2(port[name], ref[name]) <= each_tol, (name, _rel_l2(port[name],
                                                                             ref[name]))
    assert _dist(port, ref, skip) <= vec_tol, _dist(port, ref, skip)
    if f32 is not None:
        assert vec_tol < _dist(f32, ref, skip), (_dist(port, ref, skip),
                                                 _dist(f32, ref, skip))


# ------------------------------------------------------ the fused operator --

_OPS_CASES = [(8, 24, 24), (16, 16, 40)]
_OPS_IDS = ['K8_E=D', 'K16_E>D']


@pytest.mark.parametrize('K,D,E', _OPS_CASES, ids=_OPS_IDS)
def test_sattn_bf16_plain_matches_jax_kernel(K, D, E):
    '''sattn_plain(compute_dtype=bf16) against JAX fused_gathered_attention(
    compute_dtype=jnp.bfloat16) (its _fwd_kernel in interpret mode), B 2,
    N 37; the f32 plain version fails the same gate.'''
    q, gf, rel, p = _case(K + D + E, 2, 37, K, D, E)
    ref = np.asarray(j_fga(jnp.asarray(q), jnp.asarray(gf), jnp.asarray(rel),
                           jax.tree_util.tree_map(jnp.asarray, p), K,
                           compute_dtype=jnp.bfloat16))
    args = (_t(q), _t(gf), _t(rel), _torch_params(p))
    out = t_sattn.sattn_plain(*args, compute_dtype=BF)
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, 37, D)
    assert _rel_l2(out, ref) <= FTOL < _rel_l2(t_sattn.sattn_plain(*args), ref)


@pytest.mark.parametrize('K,D,E', _OPS_CASES, ids=_OPS_IDS)
def test_sattn_bf16_bwd_plain_matches_jax_vjp(K, D, E):
    '''sattn_bwd_plain(compute_dtype=bf16) against jax.vjp of
    fused_gathered_attention(compute_dtype=jnp.bfloat16) (its _bwd_kernel
    in interpret mode): dq, dgf and the ten weight gradients, dgf and the
    weight kernels' gradients bf16 values; each gate rejects the f32
    gradients. The autograd operator's gradients are the plain ones.'''
    q, gf, rel, p = _case(200 + K + D + E, 2, 37, K, D, E)
    go = np.random.RandomState(9).randn(2, 37, D).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c, pp: j_fga(a, b, c, pp, K, compute_dtype=jnp.bfloat16),
                     jnp.asarray(q), jnp.asarray(gf), jnp.asarray(rel),
                     jax.tree_util.tree_map(jnp.asarray, p))
    jdq, jdgf, jdrel, jdw = vjp(jnp.asarray(go))
    assert not np.asarray(jdrel).any()
    ref = dict(dq=jdq, dgf=jdgf, **{f'{n}/{leaf}': v for n, d in jdw.items()
                                     for leaf, v in d.items()})

    def flat(dq, dgf, dw):
        return dict(dq=dq.numpy(), dgf=dgf.numpy(),
                    **{f'{n}/{leaf}': v.numpy() for (n, leaf), v in dw.items()})
    args = (_t(q), _t(gf), _t(rel), _torch_params(p), _t(go))
    dq, dgf, dw = t_sattn.sattn_bwd_plain(*args, compute_dtype=BF)
    port, f32 = flat(dq, dgf, dw), flat(*t_sattn.sattn_bwd_plain(*args))
    for name in ref:
        if _zero_grad(name):
            assert float(np.abs(port[name] - _np(ref[name])).max()) <= ZERO_ATOL, name
            continue
        assert _rel_l2(port[name], ref[name]) <= GTOL < _rel_l2(f32[name], ref[name]), (
            name, _rel_l2(port[name], ref[name]), _rel_l2(f32[name], ref[name]))
    for name, v in port.items():        # the VJP's casts to the bf16 operands.
        if name == 'dgf' or name.endswith('/kernel'):
            assert np.array_equal(v, t_attn.round_bf16(torch.tensor(v)).numpy()), name

    tq, tgf = _t(q).requires_grad_(True), _t(gf).requires_grad_(True)
    tp = {n: {leaf: v.requires_grad_(True) for leaf, v in d.items()}
          for n, d in _torch_params(p).items()}
    out = t_sattn.fused_gathered_attention(tq, tgf, _t(rel), tp, K, compute_dtype=BF)
    assert torch.equal(out, t_sattn.sattn_plain(*args[:4], compute_dtype=BF))
    leaves = [tp[n][leaf] for n, leaf in dw]
    grads = torch.autograd.grad(out, [tq, tgf] + leaves, _t(go))
    assert torch.equal(grads[0], dq) and torch.equal(grads[1], dgf)
    for g, key in zip(grads[2:], dw):
        assert torch.equal(g, dw[key]), key


def test_gather_rows_bf16_matches_jax():
    '''gather_rows of bf16 values (the 'on' encoder's neighbour rows): the
    rows exactly JAX's gather of the same bf16 values, as f32; the VJP, the
    bf16 scatter, against the transpose of JAX's take_along_axis on a bf16
    cotangent: JAX adds the rows' cotangents in bf16, rounding each sum, the
    port sums in f32 and rounds once, so the port lies within relative L2
    1e-2 of JAX's (3.5e-3 measured) and nearer the exact (float64) sum.'''
    rng = np.random.RandomState(4)
    vals = rng.randn(2, 50, 12).astype(np.float32)
    idx = rng.randint(0, 50, (2, 40, 8))
    go = rng.randn(2, 40, 8, 12).astype(np.float32)

    def jgather(v):
        flat = jnp.asarray(idx.reshape(2, -1))[..., None]
        return jnp.take_along_axis(v, flat, axis=1).reshape(2, 40, 8, 12)
    jv = jnp.asarray(vals).astype(jnp.bfloat16)
    rows, vjp = jax.vjp(jgather, jv)
    jd, = vjp(jnp.asarray(go).astype(jnp.bfloat16))
    tv = _t(vals).to(BF).requires_grad_(True)
    trows = t_attn.gather_rows(tv, _t(idx))
    assert trows.dtype == torch.float32
    np.testing.assert_array_equal(trows.detach().numpy(), _np(rows))
    d, = torch.autograd.grad(trows, [tv], _t(go).to(BF).float())
    cot = _np(jnp.asarray(go).astype(jnp.bfloat16)).astype(np.float64)
    exact = np.zeros((2, 50, 12))
    for b in range(2):
        np.add.at(exact[b], idx[b].ravel(), cot[b].reshape(-1, 12))
    assert d.dtype == BF and _rel_l2(d.float(), _np(jd)) <= 1e-2
    assert _rel_l2(d.float(), exact) < _rel_l2(_np(jd), exact)


# --------------------------------------------------------------- modules --

def _module_grads(mod, x, pos):
    xx = _t(x).requires_grad_(True)
    out = mod(xx, _t(pos))
    grads = torch.autograd.grad(torch.sin(out.float() * 3.0).sum(),
                                [xx] + list(mod.parameters()))
    names = ['x'] + [n for n, _ in mod.named_parameters()]
    return out.detach(), {n: g.numpy() for n, g in zip(names, grads)}


@pytest.mark.parametrize('fused', ['auto', 'on'])
@pytest.mark.parametrize('K', [8, 16])
def test_vector_attention_bf16_matches_jax(monkeypatch, fused, K):
    '''A bf16 VectorAttention against the JAX module with dtype=bfloat16,
    the chain ('auto') and the fused path ('on', its Pallas kernels in
    interpret mode): the forward bit for bit on JAX's strict compile, and
    the gradients of the input and every weight.'''
    calls = []
    spy = t_layers.fused_gathered_attention
    monkeypatch.setattr(t_layers, 'fused_gathered_attention',
                        lambda *a, **k: calls.append(k['compute_dtype']) or spy(*a, **k))
    D = 24
    rng = np.random.RandomState(K)
    x = rng.rand(2, 41, D).astype(np.float32)
    pos = (rng.rand(2, 41, 3) * 2 - 1).astype(np.float32)
    jmod = JVectorAttention(dim=D, num_neighbors=K, fused=fused, dtype=jnp.bfloat16)
    v = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(K), jnp.asarray(x), jnp.asarray(pos)))
    ref = _strict(jmod.apply, v, jnp.asarray(x), jnp.asarray(pos))
    assert ref.dtype == jnp.bfloat16

    def loss(vv, xx):
        out = jmod.apply(vv, xx, jnp.asarray(pos)).astype(jnp.float32)
        return jnp.sum(jnp.sin(out * 3.0))
    jgv, jgx = _strict(jax.grad(loss, argnums=(0, 1)), v, jnp.asarray(x))
    tmod = VectorAttention(D, num_neighbors=K, fused=fused, dtype=BF)
    tmod.load_state_dict(from_jax_params(v, tmod), strict=True)
    t32 = VectorAttention(D, num_neighbors=K, fused=fused)
    t32.load_state_dict(tmod.state_dict())
    out, port = _module_grads(tmod, x, pos)
    out32, f32 = _module_grads(t32, x, pos)
    assert calls == ([BF, torch.float32] if fused == 'on' else [])
    assert out.dtype == BF
    assert _rel_l2(out.float(), _np(ref)) <= 1e-3 < _rel_l2(out32, _np(ref))
    jg = {'x': np.asarray(jgx)}
    jg.update({n: t.numpy() for n, t in from_jax_params(_np_tree(jgv), tmod).items()})
    if fused == 'on':
        _check_grads(port, f32, jg, GTOL_ON, 1e-3)
    else:
        _check_grads(port, f32, jg, GTOL_CHAIN, 2e-3, skip=_cancelling)


_ENC_TINY = dict(n_input=300, n_output=300, d_in=8, d_out=1, d_feat=8, down_blocks=2,
                 up_blocks=2, transition_factor=3, pt_num_neighbors=8, down_neighbors=6,
                 global_dim=16, fps_random_start=False)


@pytest.mark.parametrize('fused', ['auto', 'on'])
@pytest.mark.parametrize('norm,levels', [('none', 1), ('layer', 2)])
def test_encoder_bf16_matches_jax(fused, norm, levels):
    '''A bf16 PointEncoder against the JAX encoder with dtype=bfloat16
    (pt_norm_type 'none' with one abstract level, 'layer' with two; the
    chain and the fused self-attention): both outputs bf16 and bit-equal on
    JAX's strict compile, pcl_out's positions the input positions rounded to
    bf16 (the kNN graphs and FPS ran on f32 positions), and every encoder
    gradient of a seeded projection of both outputs.'''
    args = dict(_ENC_TINY, pt_norm_type=norm, abstract_levels=levels)
    rng = np.random.RandomState(20 + levels)
    pcl = (rng.rand(1, 300, 8) * 2 - 1).astype(np.float32)
    jenc = JEncoder(fused_attention=fused, dtype=jnp.bfloat16, **args)
    v = _np_tree(jax.jit(jenc.init)(jax.random.PRNGKey(levels), jnp.asarray(pcl)))
    ref_abs, ref_g, _ = _strict(jenc.apply, v, jnp.asarray(pcl))
    w_abs = rng.randn(*ref_abs.shape).astype(np.float32)
    w_g = rng.randn(*ref_g.shape).astype(np.float32)

    def loss(vv):
        a, g, _ = jenc.apply(vv, jnp.asarray(pcl))
        return (jnp.sum(a.astype(jnp.float32) * w_abs)
                + jnp.sum(g.astype(jnp.float32) * w_g))
    jg = from_jax_params(_np_tree(_strict(jax.grad(loss), v)), PointEncoder(**args))
    res = {}
    for name, dt in (('bf16', BF), ('f32', torch.float32)):
        tenc = PointEncoder(fused_attention=fused, dtype=dt, **args)
        tenc.load_state_dict(from_jax_params(v, tenc), strict=True)
        a, g = tenc(_t(pcl))
        t_loss = (a.float() * _t(w_abs)).sum() + (g.float() * _t(w_g)).sum()
        grads = torch.autograd.grad(t_loss, list(tenc.parameters()))
        res[name] = (a.detach(), g.detach(),
                     {n: gr.numpy() for (n, _), gr in zip(tenc.named_parameters(), grads)})
    a, g, port = res['bf16']
    assert a.dtype == g.dtype == BF
    assert a.shape == ref_abs.shape and g.shape == ref_g.shape
    np.testing.assert_array_equal(a[..., :3].float().numpy(), _np(ref_abs)[..., :3])
    # Every level's positions are input points, rounded to bf16.
    pts = _t(pcl)[0, :, :3].to(BF).float()
    assert all(bool((pts == p).all(-1).any()) for p in a[0, :, :3].float())
    for out, ref, out32 in ((a, ref_abs, res['f32'][0]), (g, ref_g, res['f32'][1])):
        assert _rel_l2(out.float(), _np(ref)) <= 1e-3 < _rel_l2(out32, _np(ref))
    jg = {n: t.numpy() for n, t in jg.items()}
    if fused == 'on':
        _check_grads(port, res['f32'][2], jg, GTOL_ON, 1.5e-2)
    else:
        # The chain's bf16 backward through three blocks and two pools:
        # held as one vector (5.8e-3 / 8.4e-3 measured, the f32 port's
        # 2.5e-2 / 6.2e-2; per gradient up to 1.2e-1 in both modes).
        assert _dist(port, jg) <= 1.5e-2 < _dist(res['f32'][2], jg), (
            _dist(port, jg), _dist(res['f32'][2], jg))


def test_decoder_module_path_bf16_matches_jax():
    '''A bf16 LocalImplicitField on its module path (the path the pipeline
    takes for configurations supports_fused rejects) against the JAX module
    with dtype=bfloat16 on bf16 encoder outputs: the output and every
    gradient, incl. the abstract cloud's and the global embedding's.'''
    rng = np.random.RandomState(5)
    q = np.concatenate([rng.rand(1, 60, 3) * 2 - 1, np.zeros((1, 60, 1))],
                       -1).astype(np.float32)
    ab = (rng.rand(1, 29, 3 + 32) * 2 - 1).astype(np.float32)
    fg = rng.randn(1, 16).astype(np.float32)
    jab, jfg = jnp.asarray(ab).astype(jnp.bfloat16), jnp.asarray(fg).astype(jnp.bfloat16)
    jdec = JField(dtype=jnp.bfloat16, **_DEC)
    v = _np_tree(jax.jit(jdec.init)(jax.random.PRNGKey(2), jnp.asarray(q), jab, jfg))
    ref = _strict(lambda vv, a, g: jdec.apply(vv, jnp.asarray(q), a, g)[0], v, jab, jfg)
    w = rng.randn(*ref.shape).astype(np.float32)

    def loss(vv, a, g):
        return jnp.sum(jdec.apply(vv, jnp.asarray(q), a, g)[0].astype(jnp.float32) * w)
    jgv, jga, jgg = _strict(jax.grad(loss, argnums=(0, 1, 2)), v, jab, jfg)
    res = {}
    for name, dt in (('bf16', BF), ('f32', torch.float32)):
        tdec = LocalImplicitField(dtype=dt, **_DEC)
        tdec.load_state_dict(from_jax_params(v, tdec), strict=True)
        ta = _t(ab).to(BF).to(dt).requires_grad_(True)
        tg = _t(fg).to(BF).to(dt).requires_grad_(True)
        out = tdec(_t(q), ta, tg)[0]
        grads = torch.autograd.grad((out.float() * _t(w)).sum(),
                                    [ta, tg] + list(tdec.parameters()))
        names = ['abstract', 'global'] + ['dec.' + n for n, _ in tdec.named_parameters()]
        res[name] = (out.detach(), {n: gr.float().numpy() for n, gr in zip(names, grads)})
    out, port = res['bf16']
    assert out.dtype == BF
    assert _rel_l2(out.float(), _np(ref)) <= 1e-3 < _rel_l2(res['f32'][0], _np(ref))
    jg = {'abstract': _np(jga), 'global': _np(jgg)}
    jg.update({'dec.' + n: t.numpy() for n, t in from_jax_params(_np_tree(jgv),
                                                                   tdec).items()})
    _check_grads(port, res['f32'][1], jg, GTOL_CHAIN, 2e-2, skip=_cancelling)


# ------------------------------------------------------------- train step --

def _lockstep(fused):
    '''The JAX pipeline with mixed_precision's bf16 modules (encoder
    fused_attention=fused, the fused decoder 'on' in f32) and the port's on
    the same weights and fixed supervision.'''
    rng = np.random.RandomState(3)
    pcl = (rng.rand(1, 256, 8) * 2.0 - 1.0).astype(np.float32)
    queries, targets = _supervision(2, 96, 13)
    jenc = JEncoder(fused_attention=fused, dtype=jnp.bfloat16, **_ENC)
    jdec = JField(dtype=jnp.bfloat16, **_DEC)
    enc_vars = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(pcl))
    ab, fg, _ = jenc.apply(enc_vars, jnp.asarray(pcl))
    dec_vars = jax.jit(jdec.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 4)), ab, fg)
    pcfg = dict(color_mode='rgb_nosigmoid', semantic_classes=13, past_frames=2,
                future_frames=0, **_LWS)
    jpipe = JTrainPipeline(jenc, jdec, JSamplerConfig(), JPipelineConfig(**pcfg),
                           remat=True, fused_decoder='on', fused_decoder_dtype='f32')
    jpipe.sampler = _JFixedSampler(queries, targets, 48)
    tenc = PointEncoder(fused_attention=fused, dtype=BF, **_ENC)
    tdec = LocalImplicitField(dtype=BF, **_DEC)
    tenc.load_state_dict(from_jax_params(_np_tree(enc_vars), tenc), strict=True)
    tdec.load_state_dict(from_jax_params(_np_tree(dec_vars), tdec), strict=True)
    tpipe = TrainPipeline(tenc.train(), tdec.train(), SamplerConfig(), PipelineConfig(**pcfg))
    tpipe.sampler = _TFixedSampler(queries, targets, 48)
    batch = dict(pcl_input=pcl, pcl_target=np.zeros((1, 2, 8, 9), np.float32),
                 pcl_target_valid=np.ones((1, 2, 8), bool),
                 valo_ids=np.zeros((1, 4), np.int32), num_valo_ids=np.zeros((1,), np.int32))
    return jpipe, tpipe, dict(encoder=enc_vars, decoder=dec_vars), batch


@pytest.mark.parametrize('fused', ['auto', 'on'])
def test_mixed_precision_train_step_lockstep_with_jax(monkeypatch, fused):
    '''The port's mixed-precision train step (bf16 modules, AdamW eps 1e-4
    from build_optimizer, the encoder's chain or its fused self-attention in
    bf16) against JAX make_train_step with mixed_precision's bf16 modules
    and optimizer (the fused decoder 'on' on both sides), 3 steps from one
    init under a fixed sampler: every step's losses and the parameters after
    every step.'''
    calls = []
    bwd = t_sattn.sattn_bwd_plain
    monkeypatch.setattr(t_sattn, 'sattn_bwd_plain',
                        lambda *a, **k: calls.append(a[5]) or bwd(*a, **k))
    jpipe, tpipe, jparams, batch = _lockstep(fused)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: _t(v) for k, v in batch.items()}
    cfg = dict(learn_rate=1e-3, num_epochs=20, lr_decay=0.5, gradient_clip=0.2,
               mixed_precision=True)
    tx, _ = j_build_optimizer(JTrainConfig(**cfg), 1000)
    t_params = dict(tpipe.encoder.named_parameters(), **{
        'dec.' + n: p for n, p in tpipe.decoder.named_parameters()})
    assert all(p.dtype == torch.float32 for p in t_params.values())
    opt = build_optimizer(TrainConfig(**cfg), 1000, list(t_params.values()))
    assert opt.eps == 1e-4

    state = dict(params=jparams, opt_state=tx.init(jparams), step=jnp.zeros((), jnp.int32))
    jstep = j_make_train_step(jpipe, tx).lower(state, jbatch, jax.random.PRNGKey(0)) \
        .compile(compiler_options=STRICT)
    tstep = make_train_step(tpipe, opt)
    init = {n: p.detach().clone() for n, p in t_params.items()}
    for i in range(3):
        state, jm = jstep(state, jbatch, jax.random.PRNGKey(i))
        tm = tstep(tbatch, torch.Generator())
        for k in ('total_loss', 'loss_dens', 'loss_rgb', 'loss_track'):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-2,
                                       err_msg=f'step {i} {k}')
        assert bool(tm['grads_finite']) and bool(tm['params_finite'])
        jp = _np_tree(state['params'])
        ref = dict(from_jax_params(jp['encoder'], tpipe.encoder))
        ref.update({'dec.' + k: v for k, v in from_jax_params(jp['decoder'],
                                                               tpipe.decoder).items()})
        dt = torch.cat([(t_params[n].detach() - init[n]).ravel() for n in t_params])
        dj = torch.cat([(ref[n] - init[n]).ravel() for n in t_params])
        rel = float((dt - dj).norm() / dt.norm())
        assert rel < 3e-2, (i, rel)
    assert calls == ([BF] * 9 if fused == 'on' else [])   # three blocks, three steps.


def _trainer_cfg(**over):
    return TrainConfig(**dict(dict(
        n_points=256, pt_feat_dim=8, up_down_blocks=2, pt_num_neighbors=8, down_neighbors=6,
        global_size=16, implicit_mlp_blocks=3, cross_attn_layers=2, cross_attn_neighbors=6,
        cr_attn_type='cc', num_cr_local_feats=4, color_mode='rgb_nosigmoid',
        tracking_lw=1.0, color_lw=1.0, cr_cube_bounds=2.0, num_cr_solid=48,
        past_frames=2, batch_size=2, mixed_precision=True), **over))


@pytest.mark.parametrize('fused,decoder_dtype', [('auto', 'f32'), ('on', 'bf16')])
def test_trainer_mixed_precision_on_the_cpu(fused, decoder_dtype):
    '''Trainer(TrainConfig(mixed_precision=True), device='cpu') builds both
    networks in bf16 over f32 parameters, its optimizer's eps is 1e-4
    (1e-8 without the flag), and it steps, with the encoder's chain or its
    fused self-attention and either fused decoder dtype.'''
    from test_torch_train import _tiny_batch
    tr = Trainer(_trainer_cfg(fused_decoder_dtype=decoder_dtype), device='cpu',
                 fused_attention=fused).init_state(seed=0)
    assert tr.dtype == BF and isinstance(tr.optimizer, AdamW) and tr.optimizer.eps == 1e-4
    assert {m.dtype for m in tr.encoder.modules() if isinstance(m, VectorAttention)} == {BF}
    assert {m.fused for m in tr.encoder.modules() if isinstance(m, VectorAttention)} == {fused}
    assert tr.decoder.dtype == BF and tr.encoder.dtype == BF
    assert all(p.dtype == torch.float32 for p in tr.optimizer.params)
    before = [p.detach().clone() for p in tr.optimizer.params]
    for _ in range(2):
        m = tr.step(_tiny_batch())
        assert np.isfinite(float(m['total_loss'])) and bool(m['grads_finite'])
    assert any(not torch.equal(p, q) for p, q in zip(tr.optimizer.params, before))
    assert Trainer(_trainer_cfg(mixed_precision=False), device='cpu').init_state(
        seed=0).optimizer.eps == 1e-8
