'''
The port's eval driver (evaluate/test_driver.py, config.test_args) against the
JAX package's, on the CPU:
  * test_args on both anchors' committed eval_argv gives the JAX package's
    fields (device aside: 'cuda' here, 'tpu' there);
  * main / run_test on a tiny seeded model (flax init with a steep output
    layer, saved as a JAX checkpoint, read through the port's load_models and
    from_jax_params) and a synthetic GREATER scene, with --save_metrics and
    --save_gt: the same artifacts (pcl_io_s*.p, metadata_s*.p, metrics.json),
    the inputs, targets, queries and abstract positions bit for bit, each
    per-frame metric within the anchor tolerance max(0.02, 3%).
    --track_mode none here: an untrained model's track reruns differ only by
    the mark column's faint effect, so which rerun wins a query is decided by
    rounding (the encoders' kNN distances round differently; the anchors,
    trained, run 'all' in test_torch_anchor.py);
  * --eval_overlap true and false (--track_mode all, --save_gt) give the same
    metrics.json values and artifacts bit for bit; an error on the post
    worker fails run_test;
  * store_activations and query_parallel > 1 (not ported) raise; the
    command line refuses a --device other than 'cuda' and --worker_mode
    process.
'''

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occlusions4d_tpu import checkpoint as j_ckpt
from occlusions4d_tpu.config import TrainConfig as JTrainConfig
from occlusions4d_tpu.config import test_args as j_test_args
from occlusions4d_tpu.data import loader as j_loader
from occlusions4d_tpu.data import synthetic as j_synthetic
from occlusions4d_tpu.evaluate import test_driver as j_driver
from occlusions4d_tpu.models import factory as j_factory
from occlusions4d_torch.config import test_args as parse_test_args
from occlusions4d_torch.evaluate import test_driver
from occlusions4d_torch.evaluate.inference import InferenceEngine, load_models
from occlusions4d_torch.utils.logvis import StepLogger

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    '''A seeded tiny GREATER model saved as a JAX checkpoint, and a scene.'''
    root = tmp_path_factory.mktemp('eval_tiny')
    data = str(root / 'greater')
    j_synthetic.make_greater_dataset(data, num_scenes=1, num_views=2, num_frames=16,
                                     image_size=32, stages=('test',))
    cfg = JTrainConfig(
        n_points=256, n_data_rnd=512, video_len=4, frame_skip=2, past_frames=2,
        pt_cube_bounds=5.0, cr_cube_bounds=5.0, pt_feat_dim=4, up_down_blocks=2,
        transition_factor=4,
        pt_num_neighbors=4, down_neighbors=4, global_size=8, num_cr_local_feats=4,
        implicit_mlp_blocks=3, cross_attn_layers=1, cross_attn_neighbors=4,
        color_mode='rgb_nosigmoid', color_lw=1.0, tracking_lw=1.0, seed=11)
    enc, dec, enc_args, dec_args = j_factory.build_models(cfg, 'greater',
                                                          fps_random_start=False)
    pcl = jnp.asarray(np.random.RandomState(0).rand(1, 256, 8).astype(np.float32) * 2 - 1)
    enc_vars = jax.jit(enc.init)(jax.random.PRNGKey(0), pcl)
    ab, fg, _ = enc.apply(enc_vars, pcl)
    dec_vars = jax.jit(dec.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 4)), ab, fg)
    # A steep output layer with the density's median at 0.5 over the scene's
    # cube: densities far from the threshold except on a thin shell, as a
    # trained model's (at init they all sit near one value, where f32
    # rounding alone would move the metrics of so small a scene).
    dec_vars = jax.tree_util.tree_map(np.array, dec_vars)
    out = dec_vars['params']['backbone']['lin_out']
    out['kernel'] *= 25.0
    probe = np.random.RandomState(1).rand(1, 4096, 4).astype(np.float32)
    probe[..., :3] = probe[..., :3] * 10 - 5
    dens = np.asarray(dec.apply(dec_vars, jnp.asarray(probe), ab, fg)[0])[..., 0]
    out['bias'][0] -= np.median(dens)
    ckpt = str(root / 'ckpt')
    meta = dict(config=vars(cfg), encoder_args=dict(enc_args, fps_random_start=True),
                decoder_args=dec_args, data_kind='greater',
                dset_args=j_loader._train_dset_args(cfg, 'greater', None))
    state = dict(params=dict(encoder=jax.tree_util.tree_map(np.asarray, enc_vars),
                             decoder=dec_vars))
    j_ckpt.save_checkpoint(ckpt, 0, state, meta=meta)
    return root, data, ckpt


def _argv(data, ckpt, log, **kw):
    flags = dict(num_sample=16384, implicit_batch_size=4096, point_sample_mode='grid',
                 density_threshold=0.5, save_metrics='true', save_gt='true',
                 track_mode='none', use_json='false', use_data_frac=0.02, num_workers=1,
                 seed=7)
    flags.update(kw)
    argv = ['--data_path', data, '--resume', ckpt, '--log_path', str(log)]
    for k, v in flags.items():
        argv += [f'--{k}', str(v)]
    return argv


def _artifacts(log_path, test_tag):
    out_dir = os.path.join(log_path, 'test_' + test_tag)
    names = sorted(os.listdir(out_dir))
    data = {}
    for n in names:
        with open(os.path.join(out_dir, n), 'rb') as f:
            data[n] = json.load(f) if n.endswith('.json') else pickle.load(f)
    return data


@pytest.mark.parametrize('anchor', ['anchor', 'anchor_carla'])
def test_test_args_match_jax(anchor, tmp_path):
    with open(os.path.join(_ROOT, 'tests', 'assets', anchor, 'gen.json')) as f:
        argv = json.load(f)['eval_argv'] + [
            '--data_path', str(tmp_path), '--resume',
            os.path.join(_ROOT, 'tests', 'assets', anchor),
            '--log_path', str(tmp_path / 'logs' / 'anchor'), '--eval_precision', 'fast']
    got, ref = vars(parse_test_args(argv)), vars(j_test_args(argv))
    assert got.pop('device') == 'cuda' and ref.pop('device') == 'tpu'
    assert got == ref
    assert got['num_sample'] in (131072, 262144) and got['save_metrics'] is True


def test_run_test_matches_jax(tiny, tmp_path):
    _, data, ckpt = tiny
    j_args = j_test_args(_argv(data, ckpt, tmp_path / 'jax' / 'run'))
    t_args = parse_test_args(_argv(data, ckpt, tmp_path / 'torch' / 'run'))
    ref = j_driver.main(j_args)
    got = test_driver.main(t_args, device='cpu')
    assert len(got['per_frame']) == len(ref['per_frame']) == 4      # 2 steps x 2 frames.
    assert got['track_reruns_mean'] == ref['track_reruns_mean']
    for g, r in zip(got['per_frame'], ref['per_frame']):
        assert sorted(g) == sorted(r)
        for key, rv in r.items():
            assert abs(g[key] - rv) <= max(0.02, 0.03 * abs(rv)), (key, g[key], rv)
    assert {'device_infer', 'metrics', 'finish_wall', 'dispatch_wall', 'data',
            'gt_nn1'} <= set(got['phase_split_s'])
    ja = _artifacts(j_args.log_path, j_args.test_tag)
    ta = _artifacts(t_args.log_path, t_args.test_tag)
    assert sorted(ta) == sorted(ja) == ['metadata_s0.p', 'metadata_s1.p', 'metrics.json',
                                        'pcl_io_s0.p', 'pcl_io_s1.p']
    for step in (0, 1):
        for jr, tr in zip(ja[f'pcl_io_s{step}.p'], ta[f'pcl_io_s{step}.p']):
            assert len(jr) == len(tr) == 7               # save_gt: + sem, queries.
            for i in (0, 3, 5, 6):                       # input, target, sem, queries.
                np.testing.assert_array_equal(tr[i], jr[i])
            # The abstract cloud's positions (FPS picks); its features may
            # differ where kNN near-ties of the pixel-grid scene resolve
            # differently under the two packages' distance rounding.
            np.testing.assert_array_equal(tr[1][:, :3], jr[1][:, :3])
        jm, tm = ja[f'metadata_s{step}.p'], ta[f'metadata_s{step}.p']
        for a, b in zip(jm[1:], tm[1:]):
            np.testing.assert_array_equal(a, b)          # cam_RT, cam_K.
    assert ta['metrics.json']['per_frame'] == got['per_frame']


def test_overlap_matches_serial_and_worker_error_surfaces(tiny, tmp_path):
    _, data, ckpt = tiny
    runs = {}
    for overlap in ('false', 'true'):
        args = parse_test_args(_argv(data, ckpt, tmp_path / overlap / 'run',
                                     eval_overlap=overlap, track_mode='all'))
        logger = StepLogger(log_dir=args.log_path, context='test')
        summary = test_driver.main(args, logger=logger, device='cpu')
        runs[overlap] = (summary, _artifacts(args.log_path, args.test_tag), logger)
    (s_s, a_s, l_s), (s_o, a_o, l_o) = runs['false'], runs['true']
    assert s_s['mean'] == s_o['mean'] and s_s['per_frame'] == s_o['per_frame']
    assert sorted(a_s) == sorted(a_o)
    for name in a_s:
        if name.startswith('pcl_io'):
            for rec_s, rec_o in zip(a_s[name], a_o[name]):
                for x, y in zip(rec_s, rec_o):
                    np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert l_s.scalar_memory == l_o.scalar_memory

    # An exception on the post worker fails run_test on the main thread.
    args = parse_test_args(_argv(data, ckpt, tmp_path / 'boom' / 'run', eval_overlap='true'))
    loaded = load_models(args.resume, device='cpu')
    test_driver.backfill_from_train(args, loaded['train_config'])
    logger = StepLogger(log_dir=args.log_path, context='test')
    from occlusions4d_torch.data import create_test_loader
    kind, loader = create_test_loader(args, dict(loaded['dset_args']), logger)
    engine = InferenceEngine(loaded, args.color_mode, False, args.semantic_classes,
                             track_mode='none', implicit_batch_size=1024)
    orig = test_driver._FramePost.frame

    def boom(self, *a, **k):
        raise ValueError('poisoned metrics')

    test_driver._FramePost.frame = boom
    try:
        with pytest.raises(RuntimeError, match='post worker failed'):
            test_driver.run_test(args, engine, kind, loader, logger)
    finally:
        test_driver._FramePost.frame = orig


def test_unported_options_raise(tiny, tmp_path):
    _, data, ckpt = tiny
    args = parse_test_args(_argv(data, ckpt, tmp_path / 'sa' / 'run', store_activations='true',
                           eval_overlap='false'))
    with pytest.raises(NotImplementedError, match='store_activations'):
        test_driver.main(args, device='cpu')
    loaded = load_models(ckpt, device='cpu')
    for qp in (-1, 1):
        InferenceEngine(loaded, 'rgb_nosigmoid', False, 13, query_parallel=qp)
    with pytest.raises(NotImplementedError, match='query_parallel'):
        InferenceEngine(loaded, 'rgb_nosigmoid', False, 13, query_parallel=2)


@pytest.mark.parametrize('flag,value', [('device', 'cpu'), ('device', 'tpu'),
                                        ('worker_mode', 'process')])
def test_test_args_refuse_unported_modes(flag, value, tmp_path):
    '''The command line runs on the card with thread workers: a --device
    other than 'cuda' or --worker_mode process is refused, not ignored.'''
    argv = ['--data_path', str(tmp_path), '--log_path', str(tmp_path / 'logs'),
            f'--{flag}', value]
    with pytest.raises(ValueError, match=f'--{flag} {value}'):
        parse_test_args(argv)
    assert parse_test_args(argv[:4]).device == 'cuda'


def test_launch_counts_hold_under_threads():
    '''The eval driver's post worker launches kernels beside the main
    thread: each count_launch is whole (16 threads, a tiny switch interval,
    no lost update) and the counters reset to 0.'''
    import sys
    import threading
    from occlusions4d_torch.ops import _build
    import importlib
    knn = importlib.import_module('occlusions4d_torch.ops.knn')
    _build.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(knn.LAUNCHES,
                                                                        'nn1_direct')
                                                    for _ in range(3000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert _build.launch_counts()['nn1_direct'] == 16 * 3000
    _build.reset_launch_counts()
    assert set(_build.launch_counts().values()) == {0}
