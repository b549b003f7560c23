'''
The port's last leftovers held against the JAX package on the CPU, at tiny
shapes:
  (e) store_activations on the committed GREATER anchor: both engines
      decode 16384 grid queries from the same encoder outputs (JAX's)
      with store_activations: the same predicted-solid rows but for
      queries within 1e-4 of the threshold, the activations within 2e-3
      absolute of JAX's plus one float16 step (2^-10 relative), the outputs bit-equal
      with and without the flag, in query order; both eval drivers (its
      first step, tracking off) with --store_activations true write
      activations_s*.p, one float16 (solid rows, d_hidden) array a frame;
      query_parallel 2 gives the same activations as 1;
  (f) UpTransition and PointEncoder(enable_decoder=True, skip_connections=
      True) against the JAX modules (norm 'none', 'layer', and 'batch' in
      train mode against jax.jit), with the weights through
      checkpoint.from_jax_params (strict=True) and the mapping
      cross-checked against JAX's export_torch_state_dict;
  (g) model_hsv_to_rgb / model_bins_to_rgb against JAX's on seeded inputs
      (1e-6);
  (h) Logger.save_video against the JAX Logger.save_video on a seeded frame
      stack: both files decoded, equal frames (skipped without imageio).
'''

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from anchor_recipe import eval_argv, make_scene
from occlusions4d_tpu.checkpoint import export_torch_state_dict
from occlusions4d_tpu.config import test_args as j_test_args
from occlusions4d_tpu.evaluate import test_driver as j_driver
from occlusions4d_tpu.models.encoder import PointEncoder as JEncoder
from occlusions4d_tpu.models.layers import UpTransition as JUpTransition
from occlusions4d_tpu.utils import colors as j_colors
from occlusions4d_tpu.utils.logvis import Logger as JLogger
from occlusions4d_torch.checkpoint import from_jax_params
from occlusions4d_torch.config import test_args as parse_test_args
from occlusions4d_torch.evaluate import test_driver
from occlusions4d_torch.evaluate.inference import InferenceEngine, load_models
from occlusions4d_torch.models.encoder import PointEncoder
from occlusions4d_torch.models.layers import UpTransition, take_batch_stats
from occlusions4d_torch.utils import colors as t_colors
from occlusions4d_torch.utils.logvis import Logger, StepLogger


_ANCHOR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'assets', 'anchor')


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------- store_activations --

_SA_EXTRA = ['--store_activations', 'true', '--track_mode', 'none', '--num_sample', '16384',
             '--implicit_batch_size', '4096', '--save_metrics', 'false',
             '--eval_overlap', 'false']


def _activations(log_path, test_tag):
    out_dir = os.path.join(log_path, 'test_' + test_tag)
    names = sorted(n for n in os.listdir(out_dir) if n.startswith('activations_s'))
    assert names, os.listdir(out_dir)
    out = {}
    for n in names:
        with open(os.path.join(out_dir, n), 'rb') as f:
            out[n] = pickle.load(f)
    pcl = {}
    for n in sorted(os.listdir(out_dir)):
        if n.startswith('pcl_io_s'):
            with open(os.path.join(out_dir, n), 'rb') as f:
                pcl[n] = pickle.load(f)
    return out, pcl


@pytest.fixture(scope='module')
def anchor_scene(tmp_path_factory):
    return make_scene('greater', tmp_path_factory.mktemp('sa_anchor'))


def _port_run(data, log, extra=()):
    argv, _ = eval_argv('greater', data, log, _SA_EXTRA + list(extra), steps=1)
    args = parse_test_args(argv)
    test_driver.main(args, device='cpu')
    return _activations(args.log_path, args.test_tag)


def test_store_activations_match_jax():
    '''The engines on identical encoder outputs (the JAX encoder's, given
    to both decoders): the same predicted-solid rows but for queries within
    1e-4 of the threshold, the activations within 2e-3 and one float16
    step, the port's outputs bit-equal with and without the flag.'''
    from occlusions4d_tpu.evaluate.inference import InferenceEngine as JEngine
    from occlusions4d_tpu.evaluate.inference import load_models as j_load_models
    from occlusions4d_tpu.ops import blind_points_numpy
    jl, tl = j_load_models(_ANCHOR), load_models(_ANCHOR, device='cpu')
    c = tl['train_config']
    rng = np.random.RandomState(5)
    pcl = (rng.rand(tl['encoder_args']['n_input'], 8) * 2 - 1).astype(np.float32)
    q = blind_points_numpy(16384, c.min_z, c.cr_cube_bounds, 0, 'greater', c.cube_mode,
                           'grid')
    jeng = JEngine(jl, c.color_mode, False, 13, implicit_batch_size=4096,
                   store_activations=True)
    ab, fg = jeng.encode(pcl)
    j_out, j_pen = jeng.decode_all(q, ab, fg)
    j_out, j_pen = np.asarray(j_out), np.asarray(j_pen)
    plain = InferenceEngine(tl, c.color_mode, False, 13, implicit_batch_size=4096)
    sa = InferenceEngine(tl, c.color_mode, False, 13, implicit_batch_size=4096,
                         store_activations=True)
    tab, tfg = torch.tensor(np.asarray(ab)), torch.tensor(np.asarray(fg))
    out = plain.decode_all(q, tab, tfg)
    out_sa, pen = sa.decode_all(q, tab, tfg)
    assert np.array_equal(out, out_sa)
    assert pen.dtype == j_pen.dtype == np.float16
    assert pen.shape == j_pen.shape == (len(q), tl['decoder_args']['d_hidden'])
    solid, j_solid = out[:, 0] >= 0.5, j_out[:, 0] >= 0.5
    flips = solid != j_solid
    assert flips.sum() <= 2 and np.all(np.abs(j_out[flips, 0] - 0.5) < 1e-4)
    assert solid.sum() > 100
    # 2e-3, plus one float16 step (2^-10 of the value) where the two f32
    # values round to neighbouring halves.
    np.testing.assert_allclose(pen.astype(np.float32), j_pen.astype(np.float32), atol=2e-3,
                               rtol=2.0 ** -10)
    # In query order: a slice's rows are the whole run's.
    _, part = sa.decode_all(q[1000:1500], tab, tfg)
    assert np.array_equal(part, pen[1000:1500])


def test_store_activations_eval_driver(anchor_scene, tmp_path):
    '''Both eval drivers on the anchor's first step: activations_s*.p of
    the same name, one float16 (solid rows, d_hidden) array a frame, row for
    row each package's exported solid queries (the two encoders' features
    differ on this model, so the drivers' rows are not compared across the
    packages); query_parallel 2 gives the port's one-device activations.'''
    data = anchor_scene
    got, got_pcl = _port_run(data, tmp_path / 'torch' / 'run')
    argv, _ = eval_argv('greater', data, tmp_path / 'jax' / 'run', _SA_EXTRA, steps=1)
    jargs = j_test_args(argv)
    j_driver.main(jargs)
    ref, ref_pcl = _activations(jargs.log_path, jargs.test_tag)
    assert sorted(got) == sorted(ref) and sorted(got_pcl) == sorted(ref_pcl)
    d_hidden = load_models(_ANCHOR, device='cpu')['decoder_args']['d_hidden']
    for acts, pcl in ((got, got_pcl), (ref, ref_pcl)):
        for name, pcl_name in zip(sorted(acts), sorted(pcl)):
            assert len(acts[name]) == len(pcl[pcl_name]) >= 1
            for a, rec in zip(acts[name], pcl[pcl_name]):
                assert a.dtype == np.float16 and a.shape == (len(rec[2]), d_hidden)
                assert np.isfinite(a).all()
    two, _ = _port_run(data, tmp_path / 'qp2' / 'run', ['--query_parallel', '2'])
    assert sorted(two) == sorted(got)
    for name in got:
        for a, b in zip(got[name], two[name]):
            assert np.array_equal(a, b)


# -------------------------------------------------- UpTransition, decoder --

_ENC_UP = dict(n_input=256, n_output=256, d_in=8, d_out=6, d_feat=8, down_blocks=2,
               up_blocks=2, transition_factor=3, pt_num_neighbors=8, down_neighbors=6,
               skip_connections=True, enable_decoder=True, global_dim=16,
               fps_random_start=False)


@pytest.mark.parametrize('norm', ['none', 'layer', 'batch'])
def test_up_transition_matches_jax(norm):
    rng = np.random.RandomState(2)
    x1 = rng.randn(2, 40, 16).astype(np.float32)
    p1 = rng.rand(2, 40, 3).astype(np.float32) * 2 - 1
    x2 = rng.randn(2, 113, 8).astype(np.float32)
    p2 = rng.rand(2, 113, 3).astype(np.float32) * 2 - 1
    train = norm == 'batch'
    jm = JUpTransition(d_in=16, d_out=8, factor=3, knn_k=3, norm_type=norm)
    args = tuple(jnp.asarray(a) for a in (x1, p1, x2, p2))
    v = jm.init(jax.random.PRNGKey(0), *args)
    if train:
        (y, _), _ = jax.jit(lambda v, *a: jm.apply(v, *a, train=True,
                                                   mutable=['batch_stats']))(v, *args)
    else:
        y, _ = jax.jit(jm.apply)(v, *args)
    tm = UpTransition(16, 8, 3, 3, norm)
    tm.load_state_dict(from_jax_params(_np_tree(v), tm), strict=True)
    tm.train(train)
    ty, tp = tm(*(torch.tensor(a) for a in (x1, p1, x2, p2)))
    if train:
        assert len(take_batch_stats(tm)) == 2
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), atol=1e-5, rtol=1e-5)
    assert torch.equal(tp, torch.tensor(p2))


@pytest.mark.parametrize('norm', ['none', 'layer'])
def test_enable_decoder_encoder_matches_jax(norm):
    kw = dict(_ENC_UP, pt_norm_type=norm)
    pcl = (np.random.RandomState(0).rand(2, 256, 8) * 2 - 1).astype(np.float32)
    je = JEncoder(**kw)
    v = jax.jit(je.init)(jax.random.PRNGKey(0), jnp.asarray(pcl))
    out, g, lc = jax.jit(je.apply, static_argnums=2)(v, jnp.asarray(pcl), True)
    te = PointEncoder(**kw)
    sd = from_jax_params(_np_tree(v), te)
    te.load_state_dict(sd, strict=True)
    exported = export_torch_state_dict(_np_tree(v))
    assert set(exported) == set(sd)
    assert all(np.array_equal(exported[k], sd[k].numpy()) for k in sd)
    assert any(k.startswith('blocks.5.mlp1.') for k in sd) and 'post_mlp.2.weight' in sd
    t_out, t_g, t_lc = te.eval()(torch.tensor(pcl), return_intermediate=True)
    assert t_out.shape == (2, 256, 6)
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(out), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(t_g.detach().numpy(), np.asarray(g), atol=2e-5, rtol=1e-4)
    assert [tuple(c.shape) for c in t_lc] == [tuple(c.shape) for c in lc]
    for a, b in zip(t_lc, lc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------------ colors --

def test_color_decoders_match_jax():
    rng = np.random.RandomState(4)
    hsv = rng.rand(3, 50, 15).astype(np.float32)
    hsv[0, :, -2] = 0.0                        # saturation 0: gray.
    np.testing.assert_allclose(t_colors.model_hsv_to_rgb(hsv),
                               j_colors.model_hsv_to_rgb(hsv), atol=1e-6, rtol=0)
    bins = rng.randn(7, 9).astype(np.float32)
    np.testing.assert_allclose(t_colors.model_bins_to_rgb(bins),
                               j_colors.model_bins_to_rgb(bins), atol=1e-6, rtol=0)
    assert np.array_equal(t_colors.BIN_RGB_COLORS, j_colors.BIN_RGB_COLORS)


# -------------------------------------------------------------- save_video --

def test_save_video_matches_jax(tmp_path):
    imageio = pytest.importorskip('imageio.v2', reason='imageio is not installed')
    frames = np.random.RandomState(6).rand(5, 24, 32, 3).astype(np.float32)
    fp = Logger(str(tmp_path / 'torch')).save_video(frames, 'rgb', step=0)
    jfp = JLogger(str(tmp_path / 'jax')).save_video(frames, 'rgb', step=0)
    assert os.path.basename(fp) == os.path.basename(jfp)
    a, b = imageio.mimread(fp), imageio.mimread(jfp)
    assert len(a) == len(b) == 5
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    # StepLogger is the Trainer's; its galleries and videos share the folder.
    assert os.path.dirname(StepLogger(str(tmp_path / 's')).save_video(frames, 'v')) \
        .endswith('visuals')
