'''
The bf16 train mode of the port (TrainConfig.fused_decoder_dtype='bf16': the
fused decoder's operators in compute_dtype=torch.bfloat16, forward and
backward) held against the JAX package's compute_dtype=jnp.bfloat16 on the
CPU. The port runs its kernels' plain bf16 backward versions here (explicit
decompositions: attn_bwd_rows_plain, interp_bwd_plain, gather_bwd_plain in
bf16); JAX runs its Pallas kernels in interpret mode through their custom
VJPs, as its own tests run them (FORCE_PREMUL picks its projection mode).
Inputs and weights are made with numpy from a seed and handed to both.

Tolerances, each with its reason:
  * every gradient within relative L2 1e-3 of JAX's (GTOL): both round the
    same operands to bf16 and sum in f32 in another order, so an f32
    intermediate that differs by an ulp may round to the neighbouring bf16
    value, and a per-key or weight sum may round to the neighbouring bf16
    result; a gradient whose true value is zero (the softmax makes the
    logits' bias gradient vanish) within 1e-5 absolute (ZERO_ATOL);
  * each gradient test shows that GTOL separates the modes: the port's f32
    gradients on the same inputs land outside it, each gradient of one
    operator (apart from that zero gradient, rounding noise in both modes),
    and all of a decoder's as one vector (some, an output bias's, do not
    depend on the mode);
  * the lockstep: each first-step gradient within GTOL x 4 and all of them
    as one vector within GTOL (the bf16 decoder's differences carried
    through the f32 encoder and backbone), the f32 step's outside GTOL x 4;
    the losses within rtol 1e-4 and the parameter deltas within relative
    2e-2 of JAX's after every step (Adam's first steps move each weight by
    about lr x sign(g), so an entry whose gradient is near zero may move the
    other way; 5.8e-3 to 9.4e-3 measured on these inputs).
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
from occlusions4d_tpu.models import fused as j_fused
from occlusions4d_tpu.models.encoder import PointEncoder as JEncoder
from occlusions4d_tpu.models.implicit import LocalImplicitField as JField
from occlusions4d_tpu.ops import pallas_attention as j_pa
from occlusions4d_tpu.pipeline import PipelineConfig as JPipelineConfig
from occlusions4d_tpu.pipeline import TrainPipeline as JTrainPipeline
from occlusions4d_tpu.sampler import SamplerConfig as JSamplerConfig
from occlusions4d_tpu.train import build_optimizer as j_build_optimizer
from occlusions4d_tpu.train import make_train_step as j_make_train_step
from occlusions4d_torch.checkpoint import from_jax_params
from occlusions4d_torch.config import TrainConfig, config_from_dict
from occlusions4d_torch.models import LocalImplicitField, PointEncoder
from occlusions4d_torch.pipeline import PipelineConfig, TrainPipeline, resolve_decoder_dtype
from occlusions4d_torch.sampler import SamplerConfig
from occlusions4d_torch.train import Trainer, build_optimizer, make_train_step

from test_torch_cv1_train import _carla_supervision
from test_torch_train import _JFixedSampler, _TFixedSampler

t_attn = importlib.import_module('occlusions4d_torch.ops.attention')
t_fused = importlib.import_module('occlusions4d_torch.models.fused')

BF = torch.bfloat16
GTOL = 1e-3
ZERO_ATOL = 1e-5


def _zero_grad(name):
    '''The logits' bias: the softmax over the neighbours removes it, so its
    true gradient is zero and both modes give rounding noise.'''
    return name.endswith('attn_mlp_2/bias') or name.endswith('attn_mlp.2.bias')


def _t(a):
    return torch.tensor(np.asarray(a))


def _cloud(rng, *shape):
    return rng.rand(*shape).astype(np.float32) * 2 - 1


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _within(a, ref, name, tol=GTOL):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    if _zero_grad(name):
        return float(np.abs(a - ref).max()) <= ZERO_ATOL
    return _rel_l2(a, ref) <= tol


def _dist(g, ref):
    '''Relative L2 distance of all gradients but the zero ones, as one
    vector.'''
    names = [n for n in ref if not _zero_grad(n)]
    return _rel_l2(np.concatenate([np.ravel(g[n]) for n in names]),
                   np.concatenate([np.ravel(ref[n]) for n in names]))


def _check(port, f32, ref, tol=GTOL, each=True):
    '''Every gradient of `port` (name -> array) within the gate of `ref`'s,
    and `f32`'s outside it (the gate separates the modes): every gradient
    with `each`, else all of them as one vector (a decoder's output bias,
    say, gets the same gradient in both modes).'''
    assert set(port) == set(ref) == set(f32)
    for name in ref:
        assert _within(port[name], ref[name], name, tol), (name, _rel_l2(port[name],
                                                                         ref[name]))
        if each and not _zero_grad(name):
            assert not _within(f32[name], ref[name], name, tol), (
                name, _rel_l2(f32[name], ref[name]))
    assert _dist(port, ref) <= tol < _dist(f32, ref), (_dist(port, ref), _dist(f32, ref))


def _attn_params(rng, D, E, P=16):
    def w(*s):
        return (rng.randn(*s) * 0.2).astype(np.float32)
    return dict(to_k=dict(kernel=w(E, D)), to_v=dict(kernel=w(E, D)),
                pos_mlp_0=dict(kernel=w(3, P), bias=w(P)),
                pos_mlp_2=dict(kernel=w(P, D), bias=w(D)),
                attn_mlp_0=dict(kernel=w(D, 2 * D), bias=w(2 * D)),
                attn_mlp_2=dict(kernel=w(2 * D, D), bias=w(D)))


def _case(seed, B=2, N=130, M=100, D=32, E=24, k_ext=14):
    rng = np.random.RandomState(seed)
    c = dict(q=_cloud(rng, B, N, 3), pos2=_cloud(rng, B, M, 3),
             feats=rng.randn(B, M, E).astype(np.float32),
             q_proj=rng.randn(B, N, D).astype(np.float32),
             mask=rng.rand(B, M) > 0.2, B=B, N=N, M=M, D=D, E=E, k_ext=k_ext)
    c['p'] = _attn_params(rng, D, E)
    c['jknn'] = j_pa.knn_extract(jnp.asarray(c['q']), jnp.asarray(c['pos2']), k_ext,
                                 key_mask=jnp.asarray(c['mask']))
    c['tknn'] = t_attn.knn_extract(_t(c['q']), _t(c['pos2']), k_ext, key_mask=_t(c['mask']))
    return rng, c


def _flat(dq, dx, dw):
    '''{name: array} of d(q_proj), d(x) (the key features or the gathered
    rows) and every weight gradient.'''
    out = {'q_proj': dq, 'x': dx}
    out.update({f'{n}/{leaf}': v for n, d in dw.items() for leaf, v in d.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _port_attention_grads(c, go, mode, cd):
    '''Autograd of the port's operator: d(q_proj), d(feats) or d(gathered
    rows), every weight.'''
    q_proj = _t(c['q_proj']).requires_grad_(True)
    feats = _t(c['feats']).requires_grad_(True)
    tp = {n: {leaf: _t(v).requires_grad_(True) for leaf, v in d.items()}
          for n, d in c['p'].items()}
    g = None
    if mode == 'gathered':
        g = t_attn.knn_gather_rows(_t(c['pos2']), _t(c['feats']), c['tknn'], c['k_ext'],
                                   compute_dtype=cd).requires_grad_(True)
    out = t_attn.fused_knn_vector_attention(q_proj, _t(c['q']), feats, _t(c['pos2']), tp, 10,
                                            knn=c['tknn'], premul=mode == 'premul',
                                            gathered=g, compute_dtype=cd)
    out.backward(_t(go))
    dx = g.grad if mode == 'gathered' else feats.grad
    return _flat(q_proj.grad, dx, {n: {leaf: v.grad for leaf, v in d.items()}
                                   for n, d in tp.items()})


@pytest.mark.parametrize('mode', ['premul', 'per_row', 'gathered'])
def test_bf16_attention_backward_matches_jax(monkeypatch, mode):
    '''The attention's bf16 backward (attn_bwd_plain / attn_g_bwd_plain in
    bf16, through the operator's autograd) against jax.vjp of
    fused_knn_vector_attention(compute_dtype=bf16): index route in premul
    and per-row mode, and the gathered route's row cotangent.'''
    rng, c = _case(5)
    go = rng.randn(c['B'], c['N'], c['D']).astype(np.float32)
    monkeypatch.setattr(j_pa, 'FORCE_PREMUL', mode == 'premul')
    jp = jax.tree_util.tree_map(jnp.asarray, c['p'])
    if mode == 'gathered':
        jg = j_pa.knn_gather_rows(jnp.asarray(c['pos2']), jnp.asarray(c['feats']), c['jknn'],
                                  c['k_ext'], compute_dtype=jnp.bfloat16)

        def f(qp, x, pp):
            return j_pa.fused_knn_vector_attention(
                qp, jnp.asarray(c['q']), jnp.asarray(c['feats']), jnp.asarray(c['pos2']), pp,
                10, knn=c['jknn'], gathered=x, compute_dtype=jnp.bfloat16)
        x0 = jg
    else:
        def f(qp, x, pp):
            return j_pa.fused_knn_vector_attention(
                qp, jnp.asarray(c['q']), x, jnp.asarray(c['pos2']), pp, 10,
                key_mask=jnp.asarray(c['mask']), knn=c['jknn'], compute_dtype=jnp.bfloat16)
        x0 = jnp.asarray(c['feats'])
    _, vjp = jax.vjp(f, jnp.asarray(c['q_proj']), x0, jp)
    jdq, jdx, jdw = vjp(jnp.asarray(go))
    if mode == 'gathered':
        jdx = jdx[:, :, :c['N']]
    ref = _flat(jdq, jdx, jdw)
    port = _port_attention_grads(c, go, mode, BF)
    f32 = _port_attention_grads(c, go, mode, torch.float32)
    _check(port, f32, ref)
    if mode == 'gathered':   # dg's zero rows and position columns, exactly.
        assert not port['x'][:, 10:].any() and not port['x'][..., c['E']:].any()


@pytest.mark.parametrize('route', ['index', 'gathered'])
def test_bf16_interp_backward_matches_jax(route):
    '''The interpolation's bf16 backward against jax.vjp of
    fused_knn_interp(compute_dtype=bf16): on the index route d(feats)
    (interp_bwd_plain in bf16: each row rounded before the per-key sum, the
    sum after it); on the gathered route the rows' cotangent (f32, as JAX's
    _interp_g_bwd_kernel, which has no compute dtype).'''
    rng, c = _case(6)
    K = 8
    go = rng.randn(c['B'], c['N'], c['E']).astype(np.float32)
    jg = tg = None
    if route == 'gathered':
        jg = j_pa.knn_gather_rows(jnp.asarray(c['pos2']), jnp.asarray(c['feats']), c['jknn'],
                                  c['k_ext'], compute_dtype=jnp.bfloat16)

    def f(x):
        return j_pa.fused_knn_interp(
            jnp.asarray(c['q']), jnp.asarray(c['pos2']),
            jnp.asarray(c['feats']) if route == 'gathered' else x, K,
            key_mask=jnp.asarray(c['mask']), knn=c['jknn'],
            gathered=x if route == 'gathered' else None, compute_dtype=jnp.bfloat16)
    _, vjp = jax.vjp(f, jg if route == 'gathered' else jnp.asarray(c['feats']))
    ref = np.asarray(vjp(jnp.asarray(go))[0])

    def port(cd):
        feats = _t(c['feats']).requires_grad_(True)
        x = feats
        if route == 'gathered':
            x = t_attn.knn_gather_rows(_t(c['pos2']), _t(c['feats']), c['tknn'], c['k_ext'],
                                       compute_dtype=cd).requires_grad_(True)
        out = t_attn.fused_knn_interp(_t(c['q']), _t(c['pos2']), feats, K, knn=c['tknn'],
                                      gathered=x if route == 'gathered' else None,
                                      compute_dtype=cd)
        out.backward(_t(go))
        return np.asarray(x.grad)
    if route == 'gathered':
        ref = ref[:, :, :c['N']]
        out = port(BF)
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)  # f32 in both.
        np.testing.assert_array_equal(out, port(torch.float32))
        return
    _check({'feats': port(BF)}, {'feats': port(torch.float32)}, {'feats': ref})


def test_bf16_scatter_matches_jax():
    '''The gather's bf16 VJP (gather_bwd_plain in bf16: each dg row rounded
    before the per-key sum, the sum after it) against jax.vjp of
    knn_gather_rows(compute_dtype=bf16) (the _scatter kernel), on a seeded
    cotangent over every column.'''
    rng, c = _case(7)
    k = c['k_ext']
    jg, vjp = jax.vjp(lambda f: j_pa.knn_gather_rows(jnp.asarray(c['pos2']), f, c['jknn'], k,
                                                     compute_dtype=jnp.bfloat16),
                      jnp.asarray(c['feats']))
    dg = rng.randn(c['B'], k, c['N'], c['E'] + 3).astype(np.float32)
    dgp = np.pad(dg, ((0, 0), (0, 0), (0, jg.shape[2] - c['N']), (0, 0)))
    ref = np.asarray(vjp(jnp.asarray(dgp))[0])

    def port(cd):
        return t_attn.gather_bwd_plain(c['tknn'][0], _t(dg), c['M'], k, cd)[..., :c['E']]
    _check({'feats': port(BF)}, {'feats': port(torch.float32)}, {'feats': ref})
    # The operator's backward is the same function.
    feats = _t(c['feats']).requires_grad_(True)
    g = t_attn.knn_gather_rows(_t(c['pos2']), feats, c['tknn'], k, compute_dtype=BF)
    g.backward(_t(dg))
    np.testing.assert_array_equal(feats.grad.numpy(), port(BF).numpy())


def test_bf16_shared_route_composite_matches_jax():
    '''The shared route in bf16 against JAX: one gather, the interpolation
    and two attention layers over its rows, d(feats) and every weight of
    both layers. The port's knn_gather_interp sums the layers' row
    cotangents and the interpolation's rows (o4d_interp_g_bwd) in f32, then
    runs one bf16 scatter, JAX's order.'''
    rng, c = _case(8)
    K, KI = 10, 8
    p2 = _attn_params(rng, c['D'], c['E'])
    go_i = rng.randn(c['B'], c['N'], c['E']).astype(np.float32)
    go_a = rng.randn(2, c['B'], c['N'], c['D']).astype(np.float32)
    q, pos2 = jnp.asarray(c['q']), jnp.asarray(c['pos2'])

    def route(f, pa, pb):
        g = j_pa.knn_gather_rows(pos2, f, c['jknn'], c['k_ext'], compute_dtype=jnp.bfloat16)
        return (j_pa.fused_knn_interp(q, pos2, f, KI, knn=c['jknn'], gathered=g,
                                      compute_dtype=jnp.bfloat16),
                [j_pa.fused_knn_vector_attention(jnp.asarray(c['q_proj']), q, f, pos2, pp, K,
                                                 knn=c['jknn'], gathered=g,
                                                 compute_dtype=jnp.bfloat16)
                 for pp in (pa, pb)])
    _, vjp = jax.vjp(route, jnp.asarray(c['feats']),
                     *[jax.tree_util.tree_map(jnp.asarray, p) for p in (c['p'], p2)])
    jdf, jda, jdb = vjp((jnp.asarray(go_i), [jnp.asarray(go_a[0]), jnp.asarray(go_a[1])]))
    ref = {'feats': np.asarray(jdf)}
    for tag, jd in (('a', jda), ('b', jdb)):
        ref.update({f'{tag}.{n}/{leaf}': np.asarray(v) for n, d in jd.items()
                    for leaf, v in d.items()})

    def port(cd):
        feats = _t(c['feats']).requires_grad_(True)
        tps = [{n: {leaf: _t(v).requires_grad_(True) for leaf, v in d.items()}
                for n, d in p.items()} for p in (c['p'], p2)]
        g, fl = t_attn.knn_gather_interp(_t(c['pos2']), feats, c['tknn'], c['k_ext'], KI,
                                         compute_dtype=cd)
        loss = (fl * _t(go_i)).sum()
        for i, tp in enumerate(tps):
            att = t_attn.fused_knn_vector_attention(_t(c['q_proj']), _t(c['q']), feats,
                                                    _t(c['pos2']), tp, K, knn=c['tknn'],
                                                    gathered=g, compute_dtype=cd)
            loss = loss + (att * _t(go_a[i])).sum()
        loss.backward()
        out = {'feats': feats.grad.numpy()}
        for tag, tp in zip('ab', tps):
            out.update({f'{tag}.{n}/{leaf}': v.grad.numpy() for n, d in tp.items()
                        for leaf, v in d.items()})
        return out
    _check(port(BF), port(torch.float32), ref)


# ------------------------------------------------------------- the decoder --

_DEC = dict(d_in=4, d_hidden=40, d_out=18, d_latent=40, n_blocks=4, pos_encoding_freqs=2,
            activation='relu', num_local_features=8, local_mode='attention',
            d_latent_local=24, cross_attn_neighbors=14, cross_attn_layers=2,
            cr_attn_type='cc')


@pytest.mark.parametrize('route', ['index', 'shared_gather'])
def test_bf16_fused_decoder_grads_match_jax(monkeypatch, route):
    '''fused_field_apply(compute_dtype=bf16) gradients against JAX's on the
    same weights: every decoder parameter, the abstract cloud and the global
    feature; the shared-gather route with the threshold lowered in both
    packages, as tests/test_torch_cv1.py does.'''
    rng = np.random.RandomState(9)
    E = _DEC['d_latent_local']
    q = _cloud(rng, 1, 110, 4)
    abstract = _cloud(rng, 1, 64, 3 + E)
    fg = rng.rand(1, _DEC['d_latent'] - E).astype(np.float32)
    gout = rng.randn(1, 110, _DEC['d_out']).astype(np.float32)
    if route == 'shared_gather':
        monkeypatch.setattr(j_fused, 'SHARED_GATHER_MIN_M', 1)
        monkeypatch.setattr(t_fused, 'SHARED_GATHER_MIN_M', 1)
    jdec = JField(**_DEC)
    variables = jax.tree_util.tree_map(np.array, jax.jit(jdec.init)(
        jax.random.PRNGKey(5), jnp.asarray(q[:, :16]), jnp.asarray(abstract), jnp.asarray(fg)))

    def jloss(v, a, b):
        out = j_fused.fused_field_apply(jdec, v, jnp.asarray(q), a, b,
                                        compute_dtype=jnp.bfloat16)[0]
        return jnp.sum(out * gout)
    jdv, jda, jdb = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        variables, jnp.asarray(abstract), jnp.asarray(fg))
    tdec = LocalImplicitField(**_DEC)
    ref = {f'dec.{k}': v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, jdv), tdec).items()}
    ref.update(abstract=np.asarray(jda), fg=np.asarray(jdb))

    def port(cd):
        tdec.load_state_dict(from_jax_params(variables, tdec), strict=True)
        tdec.zero_grad()
        a, b = _t(abstract).requires_grad_(True), _t(fg).requires_grad_(True)
        out = t_fused.fused_field_apply(tdec, _t(q), a, b, compute_dtype=cd)[0]
        (out * _t(gout)).sum().backward()
        res = {f'dec.{n}': p.grad.numpy().copy() for n, p in tdec.named_parameters()}
        res.update(abstract=a.grad.numpy(), fg=b.grad.numpy())
        return res
    _check(port(BF), port(torch.float32), ref, each=False)


# ---------------------------------------------------------------- lockstep --

_ENC = dict(n_input=256, n_output=256, d_in=8, d_out=1, d_feat=8, down_blocks=2,
            up_blocks=2, transition_factor=3, pt_num_neighbors=8, pt_norm_type='layer',
            down_neighbors=6, abstract_levels=2, skip_connections=False,
            enable_decoder=False, output_featurized=True, output_global_emb=True,
            global_dim=16, fps_random_start=False)
_LDEC = dict(d_in=4, d_hidden=48, d_out=18, d_latent=48, n_blocks=3, pos_encoding_freqs=8,
             activation='relu', num_local_features=4, local_mode='attention',
             d_latent_local=32, cross_attn_neighbors=6, cross_attn_layers=2,
             cr_attn_type='cc')
_PCFG = dict(color_mode='rgb_nosigmoid', semantic_classes=13, past_frames=2,
             future_frames=0, density_lw=1.0, color_lw=0.0, segmentation_lw=0.6,
             tracking_lw=0.0)


def _lockstep_pair(monkeypatch, route, dtype):
    '''A cv1-shaped JAX pipeline (fused_decoder='on', fused_decoder_dtype
    'bf16') and the port's (fused_decoder_dtype=dtype) on the same weights
    and fixed supervision, as tests/test_torch_cv1_train.py builds its f32
    lockstep; route 'shared_gather' lowers the threshold in both.'''
    if route == 'shared_gather':
        monkeypatch.setattr(j_fused, 'SHARED_GATHER_MIN_M', 1)
        monkeypatch.setattr(t_fused, 'SHARED_GATHER_MIN_M', 1)
    rng = np.random.RandomState(3)
    pcl = (rng.rand(1, 256, 8) * 2.0 - 1.0).astype(np.float32)
    queries, targets = _carla_supervision(2, 96)
    jenc, jdec = JEncoder(**_ENC), JField(**_LDEC)
    enc_vars = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(pcl))
    ab, fg, _ = jenc.apply(enc_vars, jnp.asarray(pcl))
    dec_vars = jax.jit(jdec.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 4)), ab, fg)
    jpipe = JTrainPipeline(jenc, jdec, JSamplerConfig(), JPipelineConfig(**_PCFG),
                           remat=True, fused_decoder='on', fused_decoder_dtype='bf16')
    jpipe.sampler = _JFixedSampler(queries, targets, 48)
    tenc, tdec = PointEncoder(**_ENC), LocalImplicitField(**_LDEC)
    tenc.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, enc_vars),
                                         tenc), strict=True)
    tdec.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, dec_vars),
                                         tdec), strict=True)
    tpipe = TrainPipeline(tenc.train(), tdec.train(), SamplerConfig(),
                          PipelineConfig(**_PCFG), fused_decoder_dtype=dtype)
    tpipe.sampler = _TFixedSampler(queries, targets, 48)
    batch = dict(pcl_input=pcl, pcl_target=np.zeros((1, 2, 8, 11), np.float32),
                 pcl_target_valid=np.ones((1, 2, 8), bool),
                 valo_ids=np.zeros((1, 256), np.int32), num_valo_ids=np.zeros((1,), np.int32))
    return jpipe, tpipe, dict(encoder=enc_vars, decoder=dec_vars), batch


def _named(tpipe):
    return dict(tpipe.encoder.named_parameters(), **{
        'dec.' + n: p for n, p in tpipe.decoder.named_parameters()})


def _to_torch(tree, tpipe):
    tree = jax.tree_util.tree_map(np.asarray, tree)
    ref = dict(from_jax_params(tree['encoder'], tpipe.encoder))
    ref.update({'dec.' + k: v for k, v in from_jax_params(tree['decoder'],
                                                           tpipe.decoder).items()})
    return ref


@pytest.mark.parametrize('route', ['index', 'shared_gather'])
def test_bf16_train_step_lockstep_with_jax(monkeypatch, route):
    '''The port's train step with fused_decoder_dtype='bf16' (TrainPipeline
    + build_optimizer + make_train_step, what Trainer assembles) against JAX
    make_train_step with fused_decoder='on', fused_decoder_dtype='bf16' over
    3 steps from one init, on both decoder routes: the first step's
    gradients (and the f32 port's landing outside their gate), every step's
    losses and parameters.'''
    jpipe, tpipe, jparams, batch = _lockstep_pair(monkeypatch, route, 'bf16')
    assert tpipe.decoder_dtype == BF
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: _t(v) for k, v in batch.items()}
    cfg = dict(learn_rate=1e-3, num_epochs=20, lr_decay=0.5, gradient_clip=0.2)
    tx, _ = j_build_optimizer(JTrainConfig(**cfg, mixed_precision=False), 1000)
    jg = jax.jit(jax.grad(lambda p: jpipe.loss(p, jbatch, jax.random.PRNGKey(0))[0]))(jparams)
    ref = {n: v.numpy() for n, v in _to_torch(jg, tpipe).items()}
    t_params = _named(tpipe)

    def grads(pipe):
        loss, _ = pipe.loss(tbatch, torch.Generator())
        params = _named(pipe)
        return {n: g.numpy() for n, g in zip(params, torch.autograd.grad(
            loss, list(params.values())))}
    port = grads(tpipe)
    f32 = grads(_lockstep_pair(monkeypatch, route, 'f32')[1])
    # Each parameter within 4 GTOL; the whole gradient's distance in f32 is
    # outside that gate.
    for n in ref:
        assert _within(port[n], ref[n], n, 4 * GTOL), (n, _rel_l2(port[n], ref[n]))
    assert _dist(port, ref) <= GTOL < 4 * GTOL < _dist(f32, ref), (_dist(port, ref),
                                                                  _dist(f32, ref))

    state = dict(params=jparams, opt_state=tx.init(jparams), step=jnp.zeros((), jnp.int32))
    jstep = j_make_train_step(jpipe, tx)
    tstep = make_train_step(tpipe, build_optimizer(TrainConfig(**cfg), 1000,
                                                   list(t_params.values())))
    init = {n: p.detach().clone() for n, p in t_params.items()}
    for i in range(3):
        state, jm = jstep(state, jbatch, jax.random.PRNGKey(i))
        tm = tstep(tbatch, torch.Generator())
        for k in ('total_loss', 'loss_dens', 'loss_segm'):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f'step {i} {k}')
        assert bool(tm['grads_finite']) and bool(tm['params_finite'])
        jp = _to_torch(state['params'], tpipe)
        dt = torch.cat([(t_params[n].detach() - init[n]).ravel() for n in t_params])
        dj = torch.cat([(jp[n] - init[n]).ravel() for n in t_params])
        rel = float((dt - dj).norm() / dt.norm())
        assert rel < 2e-2, (i, rel)


# ------------------------------------------------------------ configuration --

def test_fused_decoder_dtype_resolution():
    '''JAX's name and default; 'auto' resolves to f32 off a TPU (JAX's own
    rule, pipeline.py:110-116, which the port keeps on the card too); a
    checkpoint's config keeps the field; another value raises.'''
    assert TrainConfig().fused_decoder_dtype == JTrainConfig().fused_decoder_dtype == 'auto'
    assert resolve_decoder_dtype('auto') == torch.float32
    assert resolve_decoder_dtype('f32') == torch.float32
    assert resolve_decoder_dtype('bf16') == BF
    with pytest.raises(ValueError):
        resolve_decoder_dtype('fp16')
    jpipe = JTrainPipeline(JEncoder(**_ENC), JField(**_LDEC), JSamplerConfig(),
                           JPipelineConfig(**_PCFG), fused_decoder='on')
    assert jax.default_backend() != 'tpu' and jpipe.fused_decoder
    assert config_from_dict(TrainConfig, dict(fused_decoder_dtype='bf16', unknown=1)) \
        .fused_decoder_dtype == 'bf16'


def _trainer_cfg(**over):
    return TrainConfig(**dict(dict(
        n_points=256, pt_feat_dim=8, up_down_blocks=2, pt_num_neighbors=8, down_neighbors=6,
        global_size=16, implicit_mlp_blocks=3, cross_attn_layers=2, cross_attn_neighbors=6,
        cr_attn_type='cc', num_cr_local_feats=4, color_mode='rgb_nosigmoid',
        tracking_lw=1.0, color_lw=1.0, cr_cube_bounds=2.0, num_cr_solid=48,
        past_frames=2, batch_size=2), **over))


@pytest.mark.parametrize('route', ['index', 'shared_gather'])
def test_trainer_steps_in_bf16_on_the_cpu(monkeypatch, route):
    '''Trainer(cfg with fused_decoder_dtype='bf16', device='cpu') hands the
    dtype to its pipeline and steps through the plain bf16 backward
    functions, on both decoder routes (the shared one with the threshold
    lowered); 'auto' steps in f32 through the f32 ones; mixed_precision
    now builds (bf16 networks, AdamW eps 1e-4: tests/
    test_torch_mixed_precision.py steps them).'''
    from test_torch_train import _tiny_batch
    if route == 'shared_gather':
        monkeypatch.setattr(t_fused, 'SHARED_GATHER_MIN_M', 1)
    name = 'attn_bwd_plain' if route == 'index' else 'attn_g_bwd_plain'
    calls = []
    real = getattr(t_attn, name)

    def spy(*a, **kw):
        calls.append(a[-1] if len(a) > (9 if route == 'index' else 6)
                     else kw.get('compute_dtype', torch.float32))
        return real(*a, **kw)
    monkeypatch.setattr(t_attn, name, spy)
    batch = _tiny_batch()
    for dtype, want in (('bf16', BF), ('auto', torch.float32)):
        calls.clear()
        tr = Trainer(_trainer_cfg(fused_decoder_dtype=dtype), device='cpu').init_state(seed=0)
        assert tr.pipeline.decoder_dtype == want
        before = [p.detach().clone() for p in tr.optimizer.params]
        for _ in range(2):
            m = tr.step(batch)
            assert np.isfinite(float(m['total_loss'])) and bool(m['grads_finite'])
        assert any(not torch.equal(p, q) for p, q in zip(tr.optimizer.params, before))
        # Two frames, two attention layers, two steps.
        assert calls == [want] * 8
    tr = Trainer(_trainer_cfg(mixed_precision=True), device='cpu').init_state(seed=0)
    assert tr.dtype == BF and tr.optimizer.eps == 1e-4
    with pytest.raises(ValueError):
        Trainer(_trainer_cfg(fused_decoder_dtype='fp16'), device='cpu')
