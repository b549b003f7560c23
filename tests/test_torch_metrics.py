'''
The port's eval metrics and results tooling (evaluate/metrics.py,
evaluate/results.py) against the JAX package's on seeded arrays in both
datasets' layouts: frame_metrics in score and instance-id tracking modes, with
and without the driver's precomputed 1-NN, chamfer_distance, evaluate_results
over pickled results read back by load_test_results, merge_steps_into_long.
Tolerance: exact (the same numpy on the same native 1-NN), held within 1e-6.
'''

import pickle

import numpy as np
import pytest

from occlusions4d_tpu.evaluate import metrics as j_metrics
from occlusions4d_tpu.evaluate import results as j_results
from occlusions4d_torch.evaluate import metrics as t_metrics
from occlusions4d_torch.evaluate import results as t_results
from occlusions4d_torch.native import nn1_host


def _frame(rng, kind, n_solid=900, n_air=3000, m=1200, ids=False):
    '''(output_solid, output_air (compressed), target) in the eval layouts.'''
    width = 11 if kind == 'carla' else 9
    target = rng.rand(m, width).astype(np.float32)
    target[:, :3] = rng.rand(m, 3) * 4 - 2
    inst = 4 if kind == 'carla' else 3
    target[:, inst] = rng.randint(-1, 4, m)
    target[:, width - 1] = rng.rand(m) > 0.7                # GT mark.
    if kind == 'carla':
        target[:, 5] = rng.choice([1, 4, 10, 15], m)        # semantics, some >= 13.
    near = target[rng.randint(0, m, n_solid // 2), :3] + rng.randn(n_solid // 2, 3) * 0.05
    far = rng.rand(n_solid - n_solid // 2, 3) * 4 - 2
    cols = 4 + 1 + 3 + 1 + (13 if kind == 'carla' else 0)
    solid = rng.rand(n_solid, cols).astype(np.float32)
    solid[:, :3] = np.concatenate([near, far])
    solid[:, 4] = 0.5 + 0.5 * rng.rand(n_solid)
    if ids:
        solid[:, 8] = rng.randint(-1, 4, n_solid)
    air = rng.rand(n_air, 5).astype(np.float32)
    air[:, :3] = rng.rand(n_air, 3) * 4 - 2
    return solid, air, target


@pytest.mark.parametrize('kind', ['greater', 'carla'])
@pytest.mark.parametrize('ids', [False, True])
def test_frame_metrics_match_jax(kind, ids):
    rng = np.random.RandomState(7 + ids)
    solid, air, target = _frame(rng, kind, ids=ids)
    seg = kind == 'carla'
    kw = dict(data_kind=kind, point_occupancy_radius=0.2, color_mode='rgb_nosigmoid',
              predict_segmentation=seg, semantic_classes=13, mark_is_instance_id=ids)
    ref = j_metrics.frame_metrics(solid, air, target, **kw)
    got = t_metrics.frame_metrics(solid, air, target, **kw)
    assert sorted(got) == sorted(ref) and 'occupancy_f1' in got and 'color_mae' in got
    assert ('segmentation_acc' in got) == seg and 'tracking_precision' in got
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=1e-6, rel=0), k
    # The driver's precomputed 1-NN (save_gt) gives the same values.
    d_s, i_s = nn1_host(solid[:, :3], target[:, :3])
    d_a, _ = nn1_host(air[:, :3], target[:, :3])
    pre = t_metrics.frame_metrics(solid, air, target, nn_solid=(d_s, i_s), nn_air_d=d_a,
                                  **kw)
    assert pre == got
    empty = t_metrics.frame_metrics(solid[:0], air, target, **kw)
    assert empty == j_metrics.frame_metrics(solid[:0], air, target, **kw)
    assert empty['chamfer'] == float('inf')


def test_chamfer_matches_jax():
    rng = np.random.RandomState(1)
    a, b = rng.randn(700, 3).astype(np.float32), rng.randn(2500, 3).astype(np.float32)
    assert t_metrics.chamfer_distance(a, b) == j_metrics.chamfer_distance(a, b)
    assert t_metrics.chamfer_distance(a[:0], b) == float('inf')


def test_results_roundtrip_and_evaluate_match_jax(tmp_path):
    '''Pickled per-step records (the driver's pcl_io_s{step}.p layout) load
    the same through both packages' load_test_results and score the same.'''
    rng = np.random.RandomState(3)
    run = tmp_path / 'logs' / 'run_a'
    test_dir = run / 'test_t1'
    test_dir.mkdir(parents=True)
    steps = []
    for step in range(3):
        recs = []
        for t in range(2):
            solid, air, target = _frame(rng, 'greater', n_solid=300, n_air=600, m=400)
            pcl_input = rng.rand(200, 8).astype(np.float32)
            pcl_input[:, -2] = rng.randint(0, 3, 200)
            recs.append((pcl_input, rng.rand(50, 11).astype(np.float32), solid, target, air))
        steps.append(recs)
        with open(test_dir / f'pcl_io_s{step}.p', 'wb') as f:
            pickle.dump(recs, f, protocol=4)
    prefix = str(tmp_path / 'logs' / 'run')
    assert t_results.find_test_result_files(prefix) == j_results.find_test_result_files(prefix)
    got, ref = t_results.load_test_results(prefix), j_results.load_test_results(prefix)
    assert len(got) == len(ref) == 3
    for gs, rs in zip(got, ref):
        for g, r in zip(gs, rs):
            for a, b in zip(g, r):
                np.testing.assert_array_equal(a, b)
    kw = dict(data_kind='greater', color_mode='rgb_nosigmoid')
    m_got, m_ref = t_metrics.evaluate_results(got, **kw), j_metrics.evaluate_results(ref, **kw)
    assert m_got['num_frames'] == m_ref['num_frames'] == 6
    for k in m_ref:
        assert m_got[k] == pytest.approx(m_ref[k], abs=1e-6, rel=0), k
    for g, r in zip(t_results.merge_steps_into_long(got), j_results.merge_steps_into_long(ref)):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)
