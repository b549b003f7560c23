'''
The PyTorch port's training slice (occlusions4d_torch: losses, colors, the
guided sampler, the differentiable fused decoder, the optimizer, the train
pipeline and step) held against the JAX package on the CPU, at tiny widths.
Inputs are made with numpy from a seed and handed to both; weights move
through checkpoint.from_jax_params.

Tolerances, each with its reason:
  * losses and colour targets 1e-6 (same formulas, f32 rounding of a few
    transcendental ops);
  * fused decoder gradients atol 1e-5, rtol 5e-4 (the JAX package's own
    fused-vs-module tolerance, tests/test_pallas_ops.py:245-283);
  * the optimizer's update rtol 1e-6 (same formulas, same order);
  * sampler shares, weights and block assembly exact (deterministic
    functions of the data); the draws statistically, as tests/test_sampler.py
    holds the JAX sampler;
  * lockstep: losses rtol 2e-4 / atol 2e-5 and whole-model parameter deltas
    within 5e-4 of JAX's (the reference-parity lockstep's measure,
    tests/test_reference_parity.py:843-860);
  * batch norm in train mode against flax's BatchNorm: statistics rtol 1e-6,
    outputs 1e-6 of their largest magnitude (an output near zero is the
    difference of two rounded values).
'''

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# Six test workers share eight cores: keep PyTorch's CPU pool small.
torch.set_num_threads(2)

from occlusions4d_tpu import losses as j_losses
from occlusions4d_tpu.config import TrainConfig as JTrainConfig
from occlusions4d_tpu.models import factory as j_factory
from occlusions4d_tpu.models.layers import NormLayer as JNormLayer
from occlusions4d_tpu.pipeline import PipelineConfig as JPipelineConfig
from occlusions4d_tpu.pipeline import TrainPipeline as JTrainPipeline
from occlusions4d_tpu.pipeline import squash_colors as j_squash
from occlusions4d_tpu.sampler import GuidedPointSampler as JSampler
from occlusions4d_tpu.sampler import SamplerConfig as JSamplerConfig
from occlusions4d_tpu.train import build_optimizer as j_build_optimizer
from occlusions4d_tpu.train import make_train_step as j_make_train_step
from occlusions4d_tpu.utils import colors as j_colors
from occlusions4d_torch import losses as t_losses
from occlusions4d_torch.checkpoint import from_jax_params
from occlusions4d_torch.config import TrainConfig
from occlusions4d_torch.models import factory as t_factory
from occlusions4d_torch.models.encoder import PointEncoder
from occlusions4d_torch.models.fused import fused_field_apply
from occlusions4d_torch.models.implicit import LocalImplicitField
from occlusions4d_torch.models.layers import NormLayer, take_batch_stats
from occlusions4d_torch.pipeline import PipelineConfig, TrainPipeline, squash_colors
from occlusions4d_torch.sampler import GuidedPointSampler, SamplerConfig
from occlusions4d_torch.train import AdamW, Trainer, build_optimizer, make_train_step
from occlusions4d_torch.utils import colors as t_colors

t_knn = importlib.import_module('occlusions4d_torch.ops.knn')


def _t(a):
    return torch.tensor(np.asarray(a))


def _supervision(T, n_q, semantic_classes, seed=3):
    '''Fixed (queries, targets) per frame exercising every loss mask: mixed
    solid/air density, ~30% colour-unavailable rows, track in {-1, 0, 1},
    segm in [-1, S) (tests/test_reference_parity.py:677-694).'''
    rng = np.random.RandomState(seed)
    q = np.concatenate([(rng.rand(T, n_q, 3) * 4.0 - 2.0).astype(np.float32),
                        np.tile(np.arange(T, dtype=np.float32)[:, None, None],
                                (1, n_q, 1))], axis=-1)
    tgt = np.zeros((T, n_q, 6), np.float32)
    tgt[..., 0] = (rng.rand(T, n_q) < 0.5).astype(np.float32)
    rgb = rng.rand(T, n_q, 3).astype(np.float32)
    rgb[rng.rand(T, n_q) < 0.3] = -1.0
    tgt[..., 1:4] = rgb
    track = (rng.rand(T, n_q) < 0.5).astype(np.float32)
    tgt[..., 4] = np.where(rng.rand(T, n_q) < 0.25, -1.0, track)
    tgt[..., 5] = rng.randint(-1, semantic_classes, (T, n_q))
    return q, tgt


# ------------------------------------------------------------------ losses --

@pytest.mark.parametrize('color_mode', ['rgb', 'rgb_nosigmoid', 'hsv', 'bins'])
def test_losses_match_jax(color_mode):
    S = 13
    rng = np.random.RandomState(4)
    C = j_factory.decoder_out_channels(color_mode, 1.0, S)
    assert C == t_factory.decoder_out_channels(color_mode, 1.0, S)
    _, tgt = _supervision(6, 160, S)
    tgt = tgt.reshape(2, 3, 160, 6)
    raw = (rng.randn(2, 3, 160, C) * 2).astype(np.float32)
    out = np.asarray(j_squash(jnp.asarray(raw), color_mode))
    np.testing.assert_allclose(squash_colors(_t(raw), color_mode).numpy(), out,
                               atol=1e-6, rtol=1e-6)
    w = np.array([[True, True, False], [True, True, True]])
    jcfg = j_losses.LossConfig(color_mode, S, 1.0, 1.0, 0.6, 1.0)
    tcfg = t_losses.LossConfig(color_mode, S, 1.0, 1.0, 0.6, 1.0)
    jl = j_losses.per_example_losses(jnp.asarray(out), jnp.asarray(tgt), jcfg,
                                     frame_weight=jnp.asarray(w))
    tl = t_losses.per_example_losses(_t(out), _t(tgt), tcfg, frame_weight=_t(w))
    assert set(jl) == set(tl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), atol=1e-6, rtol=1e-6,
                                   err_msg=k)
        assert float(tl[k]) > 0, k
    np.testing.assert_allclose(float(t_losses.total_loss(tl, tcfg)),
                               float(j_losses.total_loss(jl, jcfg)), atol=1e-6, rtol=1e-6)
    # Zero-weight terms are not computed (no segm head without segmentation).
    jl0 = j_losses.per_example_losses(jnp.asarray(out), jnp.asarray(tgt),
                                      dataclasses.replace(jcfg, segmentation_lw=0.0))
    tl0 = t_losses.per_example_losses(_t(out), _t(tgt),
                                      dataclasses.replace(tcfg, segmentation_lw=0.0))
    assert float(tl0['segm']) == 0.0 == float(jl0['segm'])
    np.testing.assert_allclose(float(tl0['dens']), float(jl0['dens']), atol=1e-6, rtol=1e-6)


def test_color_targets_match_jax():
    rng = np.random.RandomState(5)
    rgb = rng.rand(4000, 3).astype(np.float32)
    rgb[:500] = np.round(rgb[:500] * 4) / 4           # ties in min and max.
    rgb[500:600] = 0.0
    np.testing.assert_allclose(t_colors.rgb_to_hsv(_t(rgb)).numpy(),
                               np.asarray(j_colors.rgb_to_hsv(jnp.asarray(rgb))),
                               atol=1e-6, rtol=1e-6)
    jh, js, jv = j_colors.hue_bin_targets(jnp.asarray(rgb))
    th, ts, tv = t_colors.hue_bin_targets(_t(rgb))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(t_colors.color_bin_targets(_t(rgb)).numpy(),
                                  np.asarray(j_colors.color_bin_targets(jnp.asarray(rgb))))


# ------------------------------------------------- differentiable decoder --

def test_fused_field_grads_match_jax_module_path():
    '''jax.grad of the flax decoder (module path) against autograd through
    fused_field_apply (plain versions of kernels A and B on the CPU), at the
    shapes of tests/test_pallas_ops.py:245-283: every parameter, the abstract
    features and the global embedding; abstract positions exactly zero.'''
    from occlusions4d_tpu.models.implicit import LocalImplicitField as JField
    rng = np.random.RandomState(23)
    N, M, E, Dg = 120, 64, 32, 16
    q = rng.rand(1, N, 4).astype(np.float32) * 2 - 1
    abstract = rng.rand(1, M, 3 + E).astype(np.float32)
    fg = rng.rand(1, Dg).astype(np.float32)
    args = dict(d_in=4, d_hidden=48, d_out=6, d_latent=48, n_blocks=4,
                pos_encoding_freqs=8, num_local_features=4, local_mode='attention',
                d_latent_local=E, cross_attn_neighbors=6, cross_attn_layers=2,
                cr_attn_type='cc')
    jdec = JField(**args)
    variables = jax.jit(jdec.init)(jax.random.PRNGKey(1), jnp.asarray(q[:, :16]),
                                   jnp.asarray(abstract), jnp.asarray(fg))
    w = rng.randn(1, N, 6).astype(np.float32)

    def loss(v, ab, f):
        return jnp.mean(jdec.apply(v, jnp.asarray(q), ab, f)[0] * w)
    gv, gab, gf = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        variables, jnp.asarray(abstract), jnp.asarray(fg))

    tdec = LocalImplicitField(**args)
    tdec.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, variables),
                                         tdec), strict=True)
    tab = _t(abstract).requires_grad_(True)
    tfg = _t(fg).requires_grad_(True)
    out = fused_field_apply(tdec, _t(q), tab, tfg)[0]
    (out * _t(w)).mean().backward()
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, gv), tdec)
    for name, p in tdec.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=1e-5,
                                   rtol=5e-4, err_msg=name)
    assert (tab.grad[..., :3] == 0).all()
    np.testing.assert_array_equal(np.asarray(gab)[..., :3], 0.0)
    np.testing.assert_allclose(tab.grad.numpy(), np.asarray(gab), atol=1e-5, rtol=5e-4)
    np.testing.assert_allclose(tfg.grad.numpy(), np.asarray(gf), atol=1e-5, rtol=5e-4)


# ----------------------------------------------------------------- sampler --

def _carla_frame(rng, m=3000, m_cap=3072):
    '''(M_cap, 11) CARLA layout: (x, y, z, cos, inst, sem, view, R, G, B, mark).'''
    pts = np.zeros((m_cap, 11), np.float32)
    pts[:m, 0] = rng.rand(m) * 38.0 + 0.5
    pts[:m, 1] = rng.rand(m) * 30.0 - 15.0
    pts[:m, 2] = rng.rand(m) * 5.0
    pts[:m, 3] = rng.rand(m)
    pts[:m, 4] = rng.randint(0, 20, m)
    pts[:m, 5] = rng.choice([1, 2, 4, 10, 22], m)
    pts[:m, 6] = rng.randint(0, 4, m)
    pts[:m, 7:10] = rng.rand(m, 3)
    valid = np.zeros(m_cap, bool)
    valid[:m] = True
    return pts, valid


def _greater_frame(rng, m=2000, m_cap=2048):
    '''(M_cap, 9) GREATER layout: (x, y, z, inst, view, R, G, B, mark).'''
    pts = np.zeros((m_cap, 9), np.float32)
    pts[:m, :3] = rng.rand(m, 3) * 8.0 - 4.0
    pts[:m, 2] = rng.rand(m) * 4.0
    pts[:m, 3] = rng.randint(0, 5, m)
    pts[:m, 4] = rng.randint(0, 4, m)
    pts[:m, 5:8] = rng.rand(m, 3)
    pts[:m, 8] = (rng.rand(m) > 0.8).astype(np.float32)
    valid = np.zeros(m_cap, bool)
    valid[:m] = True
    return pts, valid


_BIASED = dict(min_z=-0.5, cube_bounds=16.0, point_occupancy_radius=0.2, num_solid=512,
               num_air=716, data_kind='carla', cube_mode=4, predict_segmentation=True,
               semantic_classes=13)


@pytest.mark.parametrize('bias', ['none', 'low_moving_vehped_ivalo_sembal'])
def test_solid_shares_weights_and_assembly_match_jax(bias):
    '''The deterministic parts of the solid draw: bias shares, per-point
    weights and the contiguous-block assembly, exactly as JAX computes them.'''
    rng = np.random.RandomState(3)
    frames = [_carla_frame(rng) for _ in range(2)]
    tgt = np.stack([f[0] for f in frames])
    valid = np.stack([f[1] for f in frames])
    unique = valid & (rng.rand(*valid.shape) < 0.15)
    valo = np.full((2, 32), -1, np.int32)
    valo[:, :4] = [[1, 2, 3, 7], [4, 5, 6, 9]]
    nvalo = np.array([3, 4], np.int32)
    cfg = dict(_BIASED, point_sample_bias=bias)
    js, ts = JSampler(JSamplerConfig(**cfg)), GuidedPointSampler(SamplerConfig(**cfg))
    sh, ws = ts._solid_shares_and_weights(_t(tgt), _t(valid), _t(unique), _t(valo),
                                          _t(nvalo))
    for b in range(2):
        jsh, jws = js._solid_shares_and_weights(
            jnp.asarray(tgt[b]), jnp.asarray(valid[b]), jnp.asarray(unique[b]),
            jnp.asarray(valo[b]), jnp.asarray(nvalo[b]))
        np.testing.assert_allclose(sh[b].numpy(), np.asarray(jsh), rtol=1e-7)
        for tw, jw in zip(ws, jws):
            np.testing.assert_array_equal(tw[b].numpy(), np.asarray(jw))
        n_biased = np.floor(np.asarray(jsh)[1:] * 512).astype(np.int32)
        pools = [rng.randint(0, 3072, 512).astype(np.int32) for _ in range(6)]
        jsel = js._assemble_blocks(jnp.cumsum(jnp.asarray(n_biased)),
                                   [jnp.asarray(p) for p in pools], 512)
        tsel = ts._assemble_blocks(torch.cumsum(_t(n_biased).long(), 0)[None],
                                   [_t(p).long()[None] for p in pools], 512)
        np.testing.assert_array_equal(tsel[0].numpy(), np.asarray(jsel))
    if bias != 'none':
        assert (sh[:, 1:] > 0).any()


def test_moving_masks_air_rejection_and_shares_match_jax():
    '''Moving masks (1-NN both ways over integer-grid frames, so exact),
    air-pool rejections and survivor order, and the frame's solid and air
    shares, against the JAX sampler on the same frames.'''
    from occlusions4d_tpu.ops.knn import nn1_bidirectional as j_nn1, nn1_min_dist as j_md
    from occlusions4d_tpu.ops.select import valid_first_order as j_vfo
    rng = np.random.RandomState(7)
    tgt, valid = _carla_frame(rng)
    tgt[:, :3] = np.round(tgt[:, :3] * 4) / 4
    other = tgt.copy()
    other[:400, :3] += 5.0
    cfg = dict(_BIASED, point_sample_bias='low_moving_ivalo_sembal')
    js, ts = JSampler(JSamplerConfig(**cfg)), GuidedPointSampler(SamplerConfig(**cfg))
    jd = j_nn1(jnp.asarray(tgt[:, :3]), jnp.asarray(other[:, :3]),
               a_mask=jnp.asarray(valid), b_mask=jnp.asarray(valid))
    td = t_knn.nn1_bidirectional(_t(tgt[None, :, :3]), _t(other[None, :, :3]),
                                 a_mask=_t(valid[None]), b_mask=_t(valid[None]))
    for j, t in zip(jd, td):
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(j))
        np.testing.assert_array_equal((t[0] > 0.4).numpy(), np.asarray(j) > 0.4)
    # Air rejection: d > r on the same candidates, then valid-first order.
    cand = (tgt[:700, :3] + rng.randn(700, 3).astype(np.float32) * 0.3).astype(np.float32)
    jmin = np.asarray(j_md(jnp.asarray(cand), jnp.asarray(tgt[:, :3]),
                           key_mask=jnp.asarray(valid)))
    tmin = t_knn.nn1_min_dist(_t(cand[None]), _t(tgt[None, :, :3]),
                              key_mask=_t(valid[None]))[0].numpy()
    far = np.abs(jmin - 0.2) > 1e-4
    assert far.mean() > 0.99
    np.testing.assert_array_equal((tmin > 0.2)[far], (jmin > 0.2)[far])
    ok = tmin > 0.2
    from occlusions4d_torch.ops.select import valid_first_order
    np.testing.assert_array_equal(valid_first_order(_t(ok[None]))[0].numpy(),
                                  np.asarray(j_vfo(jnp.asarray(ok))))
    # Whole frames: the shares are deterministic functions of the data.
    valo = np.full(32, -1, np.int32)
    valo[:3] = [1, 2, 3]
    jr = js.sample_frame(jax.random.PRNGKey(3), jnp.asarray(tgt), jnp.asarray(valid),
                         jnp.asarray(other), jnp.asarray(valid), jnp.asarray(valo),
                         jnp.asarray(3), 2)
    tr = ts.sample_frame(torch.Generator().manual_seed(3), _t(tgt[None]), _t(valid[None]),
                         _t(other[None]), _t(valid[None]), _t(valo[None]),
                         _t(np.array([3])), 2)
    np.testing.assert_allclose(tr['solid_sbs'][0].numpy(), np.asarray(jr['solid_sbs']),
                               rtol=1e-6)
    np.testing.assert_allclose(tr['air_sbs'][0].numpy(), np.asarray(jr['air_sbs']),
                               rtol=1e-6)
    assert tr['solid_sbs'][0, 2] > 0 and bool(tr['ok'][0]) == bool(jr['ok'])
    # Draws: the vehped / sembal mixture enriches the same classes alike.
    seg_t = tr['solid_target'][0, :, 5].numpy()
    seg_j = np.asarray(jr['solid_target'])[:, 5]
    assert abs(np.isin(seg_t, (4, 10)).mean() - np.isin(seg_j, (4, 10)).mean()) < 0.12
    assert seg_t.min() >= 0 and seg_t.max() < 13


def _frames(rng, B=2):
    f = [_greater_frame(rng) for _ in range(B)]
    return _t(np.stack([x[0] for x in f])), _t(np.stack([x[1] for x in f]))


def _run(sampler, tgt, valid, other=None, ovalid=None, seed=0, t=0):
    other = tgt if other is None else other
    ovalid = valid if ovalid is None else ovalid
    B = tgt.shape[0]
    return sampler.sample_frame(torch.Generator().manual_seed(seed), tgt, valid, other,
                                ovalid, torch.zeros((B, 32), dtype=torch.int32),
                                torch.zeros((B,), dtype=torch.int32), t)


def test_sampler_budgets_targets_and_distances():
    '''As tests/test_sampler.py holds the JAX sampler: shapes, time channel,
    densities and fills, solid queries within r/2 of the target, air farther
    than r from it, and the exact 'none' shares.'''
    rng = np.random.RandomState(1)
    tgt, valid = _frames(rng)
    r = 0.2
    s = GuidedPointSampler(SamplerConfig(min_z=0.0, cube_bounds=5.0, point_occupancy_radius=r,
                                         num_solid=256, num_air=512, data_kind='greater'))
    res = _run(s, tgt, valid, t=3)
    si, st, ai, at = (res[k].numpy() for k in ('solid_input', 'solid_target', 'air_input',
                                              'air_target'))
    assert si.shape == (2, 256, 4) and ai.shape == (2, 512, 4) and st.shape == (2, 256, 6)
    assert res['ok'].all()
    np.testing.assert_allclose(si[..., 3], 3.0)
    np.testing.assert_allclose(ai[..., 3], 3.0)
    np.testing.assert_allclose(st[..., 0], 1.0)
    np.testing.assert_allclose(st[..., 5], -1.0)
    np.testing.assert_allclose(at[..., 0], 0.0)
    np.testing.assert_allclose(at[..., 1:], -1.0)
    for b in range(2):
        txyz = tgt[b][valid[b]][:, :3].numpy()
        d_s = np.linalg.norm(si[b, :, None, :3] - txyz[None], axis=-1).min(-1)
        d_a = np.linalg.norm(ai[b, :, None, :3] - txyz[None], axis=-1).min(-1)
        assert d_s.max() <= r / 2 + 1e-5 and d_a.min() > r - 1e-6
    np.testing.assert_allclose(res['air_sbs'].numpy(), [[0.5, 0.0, 0.3, 0.2]] * 2, rtol=1e-6)
    np.testing.assert_allclose(res['solid_sbs'].numpy(), [[1, 0, 0, 0, 0, 0]] * 2)


def test_sampler_low_block_and_draw_statistics():
    '''The 'low' block takes the first floor(0.5 S) slots from z in [0, 2];
    the regular draws are uniform over the valid rows.'''
    rng = np.random.RandomState(6)
    tgt, valid = _frames(rng)
    s = GuidedPointSampler(SamplerConfig(min_z=-1.0, cube_bounds=5.0, num_solid=4000,
                                         num_air=100, data_kind='greater',
                                         point_sample_bias='low',
                                         point_occupancy_radius=0.2))
    res = _run(s, tgt, valid, seed=7)
    np.testing.assert_allclose(res['solid_sbs'].numpy(), [[0.5, 0.5, 0, 0, 0, 0]] * 2)
    si = res['solid_input'].numpy()
    assert si[:, :2000, 2].max() <= 2.0 + 0.1 + 1e-5 and si[:, :2000, 2].min() >= -0.1 - 1e-5
    # Regular half: z uniform over [0, 4] -> about half the draws above z = 2.
    assert abs((si[:, 2000:, 2] > 2.0).mean() - 0.5) < 0.05


def test_dry_air_pools_fall_back_and_flag():
    '''A dry biased pool falls back to the regular pool (never emits rejected
    candidates); a dry regular pool flags the frame not ok.'''
    rng = np.random.RandomState(11)
    r = 0.5
    pts = np.zeros((2048, 9), np.float32)
    v = rng.randn(1900, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pts[:1900, :3] = v * (rng.rand(1900, 1) ** (1 / 3)) * 4 * r
    valid = np.zeros(2048, bool)
    valid[:1900] = True
    s = GuidedPointSampler(SamplerConfig(min_z=-5.0, cube_bounds=5.0, point_occupancy_radius=r,
                                         num_solid=32, num_air=20, data_kind='greater'))
    tgt, val = _t(np.stack([pts] * 8)), _t(np.stack([valid] * 8))
    txyz = pts[valid][:, :3]
    dry = False
    for seed in range(6):
        res = _run(s, tgt, val, seed=seed)
        counts = res['air_pool_counts'].numpy()
        assert res['ok'].all() and (counts[:, 3] > 0).all()
        dry = dry or (counts[:, 1:3] == 0).any()
        ai = res['air_input'].numpy()[..., :3].reshape(-1, 3)
        assert np.linalg.norm(ai[:, None] - txyz[None], axis=-1).min() > r - 1e-6
    assert dry, 'no dry pool seen; the test exercises nothing'
    g = np.arange(-1.0, 1.01, 0.25, dtype=np.float32)
    gz = np.arange(0.0, 1.01, 0.25, dtype=np.float32)
    xyz = np.stack(np.meshgrid(g, g, gz, indexing='ij'), -1).reshape(-1, 3)
    full = np.zeros((1, 512, 9), np.float32)
    full[0, :len(xyz), :3] = xyz
    fv = np.zeros((1, 512), bool)
    fv[0, :len(xyz)] = True
    s = GuidedPointSampler(SamplerConfig(min_z=0.0, cube_bounds=1.0, point_occupancy_radius=r,
                                         num_solid=64, num_air=64, data_kind='greater'))
    res = _run(s, _t(full), _t(fv))
    assert int(res['air_pool_counts'][0, 3]) == 0 and not bool(res['ok'][0])


def test_sampler_args_and_config_fields_match_jax():
    jcfg = JTrainConfig(num_cr_solid=100, air_sampling_ratio=1.4, tracking_lw=1.0,
                        point_sample_bias='moving', cr_cube_bounds=4.0)
    tcfg = TrainConfig(num_cr_solid=100, air_sampling_ratio=1.4, tracking_lw=1.0,
                       point_sample_bias='moving', cr_cube_bounds=4.0)
    for kind in ('greater', 'carla'):
        assert t_factory.build_sampler_args(tcfg, kind) == \
            j_factory.build_sampler_args(jcfg, kind)
    jdef = JTrainConfig()
    assert [f.name for f in dataclasses.fields(TrainConfig)] == \
        [f.name for f in dataclasses.fields(JTrainConfig)]
    assert TrainConfig().device == 'cuda' and jdef.device == 'tpu'
    for f in dataclasses.fields(TrainConfig):
        if f.name != 'device':
            assert getattr(TrainConfig(), f.name) == getattr(jdef, f.name), f.name


# -------------------------------------------------------------- optimizer --

def test_adamw_clip_and_schedule_match_optax():
    '''The optimizer against the JAX package's build_optimizer (optax): clip
    triggered and not, the LR decay boundaries crossed, weight decay on every
    leaf; a skipped step leaves everything as it was.'''
    rng = np.random.RandomState(0)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    cfg = dict(learn_rate=1e-2, lr_decay=0.3, num_epochs=5, gradient_clip=0.2)
    tx, _ = j_build_optimizer(JTrainConfig(**cfg, mixed_precision=False), 1)
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    js = tx.init(jp)
    tp = [torch.nn.Parameter(_t(p)) for p in params]
    opt = build_optimizer(TrainConfig(**cfg), 1, tp)
    import optax
    for step in range(6):
        scale = 0.01 if step % 2 else 3.0      # clip off / on.
        grads = [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]
        u, js = tx.update({str(i): jnp.asarray(g) for i, g in enumerate(grads)}, js, jp)
        jp = optax.apply_updates(jp, u)
        tg = [_t(g) for g in grads]
        norm = torch.sqrt(sum((g * g).sum() for g in tg))
        opt.update(tg, norm, torch.tensor(True))
        for i, p in enumerate(tp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[str(i)]),
                                       rtol=1e-6, atol=1e-7, err_msg=f'step {step} leaf {i}')
    before = [p.detach().clone() for p in tp] + [m.clone() for m in opt.mu]
    nan = [torch.full_like(p, float('nan')) for p in tp]
    opt.update(nan, torch.tensor(float('nan')), torch.tensor(False))
    after = [p.detach() for p in tp] + list(opt.mu)
    assert all(torch.equal(a, b) for a, b in zip(before, after)) and int(opt.count) == 6
    assert isinstance(opt, AdamW)


# --------------------------------------------------------------- lockstep --

_ENC = dict(n_input=256, n_output=256, d_in=8, d_out=1, d_feat=8, down_blocks=2,
            up_blocks=2, transition_factor=3, pt_num_neighbors=8, pt_norm_type='none',
            down_neighbors=6, abstract_levels=1, skip_connections=False,
            enable_decoder=False, output_featurized=True, output_global_emb=True,
            global_dim=16, fps_random_start=False)
_DEC = dict(d_in=4, d_hidden=48, d_out=5, d_latent=48, n_blocks=3, pos_encoding_freqs=8,
            activation='relu', num_local_features=4, local_mode='attention',
            d_latent_local=32, cross_attn_neighbors=6, cross_attn_layers=2,
            cr_attn_type='cc')
_LWS = dict(density_lw=1.0, color_lw=1.0, segmentation_lw=0.0, tracking_lw=1.0)


class _JFixedSampler:
    '''Drop-in for the JAX sampler's sample_frame returning fixed supervision
    (tests/test_reference_parity.py:657-677).'''

    def __init__(self, queries, targets, n_solid):
        self.q, self.t, self.n_solid = queries, targets, n_solid

    def sample_frame(self, key, tgt, tgt_valid, other, other_valid, valo_ids,
                     num_valo_ids, time_idx):
        t, S = int(time_idx), self.n_solid
        q, tg = jnp.asarray(self.q[t]), jnp.asarray(self.t[t])
        return dict(solid_input=q[:S], air_input=q[S:], solid_target=tg[:S],
                    air_target=tg[S:], solid_sbs=jnp.zeros((6,), jnp.float32),
                    air_sbs=jnp.zeros((4,), jnp.float32), ok=jnp.asarray(True))


class _TFixedSampler(_JFixedSampler):
    '''The same for the port's batched sampler.'''

    def sample_frame(self, gen, tgt, tgt_valid, other, other_valid, valo_ids,
                     num_valo_ids, time_idx):
        B, t, S = tgt.shape[0], int(time_idx), self.n_solid
        q = _t(self.q[t])[None].expand(B, -1, -1)
        tg = _t(self.t[t])[None].expand(B, -1, -1)
        return dict(solid_input=q[:, :S], air_input=q[:, S:], solid_target=tg[:, :S],
                    air_target=tg[:, S:], solid_sbs=torch.zeros((B, 6)),
                    air_sbs=torch.zeros((B, 4)), ok=torch.ones((B,), dtype=torch.bool))


def _lockstep_setup():
    from occlusions4d_tpu.models.encoder import PointEncoder as JEncoder
    from occlusions4d_tpu.models.implicit import LocalImplicitField as JField
    rng = np.random.RandomState(3)
    pcl = (rng.rand(1, 256, 8) * 2.0 - 1.0).astype(np.float32)
    queries, targets = _supervision(2, 96, 13)
    jenc, jdec = JEncoder(**_ENC), JField(**_DEC)
    enc_vars = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(pcl))
    ab, fg, _ = jenc.apply(enc_vars, jnp.asarray(pcl))
    dec_vars = jax.jit(jdec.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 4)), ab, fg)
    pcfg = dict(color_mode='rgb_nosigmoid', semantic_classes=13, past_frames=2,
                future_frames=0, **_LWS)
    jpipe = JTrainPipeline(jenc, jdec, JSamplerConfig(), JPipelineConfig(**pcfg),
                           remat=True, fused_decoder='off')
    jpipe.sampler = _JFixedSampler(queries, targets, 48)
    tenc, tdec = PointEncoder(**_ENC), LocalImplicitField(**_DEC)
    tenc.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, enc_vars),
                                         tenc), strict=True)
    tdec.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, dec_vars),
                                         tdec), strict=True)
    tpipe = TrainPipeline(tenc.train(), tdec.train(), SamplerConfig(), PipelineConfig(**pcfg))
    tpipe.sampler = _TFixedSampler(queries, targets, 48)
    batch = dict(pcl_input=pcl, pcl_target=np.zeros((1, 2, 8, 9), np.float32),
                 pcl_target_valid=np.ones((1, 2, 8), bool),
                 valo_ids=np.zeros((1, 4), np.int32), num_valo_ids=np.zeros((1,), np.int32))
    return jpipe, tpipe, dict(encoder=enc_vars, decoder=dec_vars), batch


def test_train_step_lockstep_with_jax():
    '''The port's train step (TrainPipeline + build_optimizer +
    make_train_step, fused decoder through the plain backward of kernels A
    and B) against the JAX package's make_train_step over 3 steps from one
    init under a fixed sampler: the first step's gradients, every step's
    losses and the parameters after every step.'''
    jpipe, tpipe, jparams, batch = _lockstep_setup()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: _t(v) for k, v in batch.items()}
    cfg = dict(learn_rate=1e-3, num_epochs=20, lr_decay=0.5, gradient_clip=0.2)
    tx, _ = j_build_optimizer(JTrainConfig(**cfg, mixed_precision=False), 1000)

    # First-step gradients, decoder and encoder, in the torch key layout.
    jg = jax.jit(jax.grad(lambda p: jpipe.loss(p, jbatch, jax.random.PRNGKey(0))[0]))(jparams)
    t_params = dict(tpipe.encoder.named_parameters(), **{
        'dec.' + n: p for n, p in tpipe.decoder.named_parameters()})
    loss, _ = tpipe.loss(tbatch, torch.Generator())
    tg = dict(zip(t_params, torch.autograd.grad(loss, list(t_params.values()))))
    ref = dict(from_jax_params(jax.tree_util.tree_map(np.asarray, jg['encoder']),
                               tpipe.encoder))
    ref.update({'dec.' + k: v for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, jg['decoder']), tpipe.decoder).items()})
    for name, g in tg.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=1e-5, rtol=5e-4,
                                   err_msg=name)

    state = dict(params=jparams, opt_state=tx.init(jparams), step=jnp.zeros((), jnp.int32))
    jstep = j_make_train_step(jpipe, tx)
    opt = build_optimizer(TrainConfig(**cfg), 1000, list(t_params.values()))
    tstep = make_train_step(tpipe, opt)
    init = {n: p.detach().clone() for n, p in t_params.items()}
    for i in range(3):
        state, jm = jstep(state, jbatch, jax.random.PRNGKey(i))
        tm = tstep(tbatch, torch.Generator())
        for k in ('total_loss', 'loss_dens', 'loss_rgb', 'loss_track', 'grad_norm'):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4, atol=2e-5,
                                       err_msg=f'step {i} {k}')
        assert bool(tm['grads_finite']) and bool(tm['params_finite'])
        jp = jax.tree_util.tree_map(np.asarray, state['params'])
        ref = dict(from_jax_params(jp['encoder'], tpipe.encoder))
        ref.update({'dec.' + k: v for k, v in from_jax_params(jp['decoder'],
                                                               tpipe.decoder).items()})
        dt = torch.cat([(t_params[n].detach() - init[n]).ravel() for n in t_params])
        dj = torch.cat([(ref[n] - init[n]).ravel() for n in t_params])
        rel = float((dt - dj).norm() / dt.norm())
        assert rel < 5e-4, (i, rel)
    assert float(tm['total_loss']) < float(jm['total_loss']) + 1e-3


# ----------------------------------------------------------- train guards --

def _tiny_trainer(**over):
    cfg = TrainConfig(**dict(dict(
        n_points=256, pt_feat_dim=8, up_down_blocks=2, pt_num_neighbors=8, down_neighbors=6,
        global_size=16, implicit_mlp_blocks=3, cross_attn_layers=2, cross_attn_neighbors=6,
        cr_attn_type='cc', num_cr_local_feats=4, color_mode='rgb_nosigmoid',
        tracking_lw=1.0, color_lw=1.0, cr_cube_bounds=2.0, num_cr_solid=48,
        past_frames=2, batch_size=2), **over))
    return Trainer(cfg, device='cpu').init_state(seed=0)


def _tiny_batch(seed=0):
    rng = np.random.RandomState(seed)
    tgt = np.zeros((2, 2, 512, 9), np.float32)
    tgt[..., :3] = rng.rand(2, 2, 512, 3) * 4 - 2
    tgt[..., 2] = np.abs(tgt[..., 2])
    tgt[..., 5:8] = rng.rand(2, 2, 512, 3)
    return dict(pcl_input=(rng.rand(2, 256, 8) * 2 - 1).astype(np.float32), pcl_target=tgt,
                pcl_target_valid=np.ones((2, 2, 512), bool),
                valo_ids=np.tile(np.arange(32, dtype=np.int32), (2, 1)),
                num_valo_ids=np.full((2,), 8, np.int32))


def test_trainer_steps_skips_non_finite_grads_and_fails_on_nan_params():
    tr = _tiny_trainer(point_sample_bias='low_moving')
    batch = _tiny_batch()
    before = [p.detach().clone() for p in tr.optimizer.params]
    losses = [float(tr.step(batch)['total_loss']) for _ in range(3)]
    assert losses[-1] < losses[0]
    assert any(not torch.equal(p, q) for p, q in zip(tr.optimizer.params, before))
    keys = {'total_loss', 'grad_norm', 'grads_finite', 'params_finite', 'sample_ok',
            'sample_ok_frac', 'solid_sbs', 'air_sbs', 'loss_dens', 'loss_rgb', 'loss_segm',
            'loss_track'}
    bad = dict(batch, pcl_input=np.full_like(batch['pcl_input'], np.nan))
    snap = [p.detach().clone() for p in tr.optimizer.params]
    m = tr.step(bad)
    assert set(m) == keys and not bool(m['grads_finite']) and bool(m['params_finite'])
    assert all(torch.equal(p, q) for p, q in zip(tr.optimizer.params, snap))
    with torch.no_grad():
        tr.optimizer.params[0].fill_(float('nan'))
    with pytest.raises(RuntimeError, match='NaN model parameter'):
        tr.step(batch)


def test_trainer_step_phase_marks_leave_the_step_unchanged():
    batch = _tiny_batch()
    plain, marked = _tiny_trainer(), _tiny_trainer()
    names = []
    m_plain = plain.step(batch)
    m_marked = marked.step(batch, mark=names.append)
    assert names == ['encoder', 'sampler', 'decoder_forward', 'decoder_backward',
                     'encoder_backward', 'optimizer']
    assert torch.equal(m_plain['total_loss'], m_marked['total_loss'])
    assert all(torch.equal(p, q) for p, q in zip(plain.optimizer.params,
                                                  marked.optimizer.params))


def test_encoder_train_mode_draws_random_fps_starts():
    tr = _tiny_trainer()
    pcl = _t((np.random.RandomState(1).rand(2, 256, 8) * 2 - 1).astype(np.float32))
    enc = tr.encoder
    a, _ = enc(pcl, generator=torch.Generator().manual_seed(1))
    b, _ = enc(pcl, generator=torch.Generator().manual_seed(2))
    c, _ = enc.eval()(pcl, generator=torch.Generator().manual_seed(1))
    d, _ = enc(pcl)
    assert not torch.equal(a[..., :3], b[..., :3])
    assert torch.equal(c, d)


_NORM_CASES = [((3, 1000, 8), 0.0), ((2, 4779, 36), 1e3), ((1, 1593, 72), 1e3),
               ((3, 256, 16), 0.0)]


def norm_pair(rng, shape, offset):
    '''One input, flax variables and the port's NormLayer holding them.'''
    D = shape[-1]
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 2.0, D) + offset).astype(np.float32)
    g, b, rm = (rng.standard_normal(D).astype(np.float32) for _ in range(3))
    rv = rng.uniform(0.5, 2.0, D).astype(np.float32)
    variables = {'params': {'norm': {'scale': jnp.asarray(g), 'bias': jnp.asarray(b)}},
                 'batch_stats': {'norm': {'mean': jnp.asarray(rm), 'var': jnp.asarray(rv)}}}
    layer = NormLayer('batch', D)
    with torch.no_grad():
        for t, v in ((layer.weight, g), (layer.bias, b), (layer.running_mean, rm),
                     (layer.running_var, rv)):
            t.copy_(_t(v))
    return x, variables, layer


def test_batch_norm_train_mode_raises():
    '''NormLayer('batch') in train mode computes what flax's BatchNorm
    computes (JAX NormLayer on the flattened (B*N, D) rows, train=True):
    outputs and updated running statistics, at inputs of mean 0 and 1e3
    (where E[x^2] - E[x]^2 keeps a few digits: the two must keep the same
    ones), and the update stays pending until taken. Eval mode normalises
    with the running statistics and leaves nothing pending.'''
    rng = np.random.default_rng(0)
    jnorm = JNormLayer('batch')
    apply = jax.jit(lambda v, x: jnorm.apply(v, x, train=True, mutable=['batch_stats']))
    for shape, offset in _NORM_CASES:
        x, variables, layer = norm_pair(rng, shape, offset)
        jy, mut = apply(variables, jnp.asarray(x.reshape(-1, shape[-1])))
        y = layer.train()(_t(x))
        assert y.shape == x.shape and layer.pending is not None
        (got_layer, mean, var), = take_batch_stats(layer)
        assert got_layer is layer and layer.pending is None and take_batch_stats(layer) == []
        jy = np.asarray(jy).reshape(shape)
        np.testing.assert_allclose(y.detach().numpy(), jy, rtol=1e-6,
                                   atol=1e-6 * np.abs(jy).max(), err_msg=str(shape))
        st = mut['batch_stats']['norm']
        np.testing.assert_allclose(mean.numpy(), np.asarray(st['mean']), rtol=1e-6)
        np.testing.assert_allclose(var.numpy(), np.asarray(st['var']), rtol=1e-6)
        # The running statistics themselves move only when committed.
        np.testing.assert_array_equal(layer.running_mean.numpy(),
                                      np.asarray(variables['batch_stats']['norm']['mean']))
        # Eval mode: the running statistics, nothing pending.
        jy_eval = jnorm.apply(variables, jnp.asarray(x.reshape(-1, shape[-1])))
        np.testing.assert_allclose(layer.eval()(_t(x)).detach().numpy(),
                                   np.asarray(jy_eval).reshape(shape), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(jy_eval)).max())
        assert layer.pending is None


def test_mixed_precision_is_carried_and_refused_for_training():
    '''The JAX config's mixed_precision survives config_from_dict (same
    default as JAX), and training with it builds what the JAX Trainer
    builds (it was refused before the port had its bf16 modules): bf16
    networks over f32 parameters, AdamW eps 1e-4 from build_optimizer, as
    JAX's optax chain (1e-8 without the flag).'''
    from occlusions4d_torch.config import config_from_dict
    assert TrainConfig().mixed_precision is JTrainConfig().mixed_precision is False
    cfg = config_from_dict(TrainConfig, dict(mixed_precision=True, n_points=256,
                                             not_a_field=1))
    assert cfg.mixed_precision is True and cfg.n_points == 256
    tr = Trainer(cfg, 'greater', device='cpu')
    assert tr.dtype == torch.bfloat16 and tr.encoder.dtype == tr.decoder.dtype == tr.dtype
    assert all(p.dtype == torch.float32 for p in tr.encoder.parameters())
    assert build_optimizer(cfg, 10, [torch.zeros(3, requires_grad=True)]).eps == 1e-4
    opt = build_optimizer(TrainConfig(), 10, [torch.zeros(3)])
    assert isinstance(opt, AdamW) and opt.eps == 1e-8
