'''
The committed anchors through the port's eval driver on the CPU (the checks
of tests/test_anchor.py, with occlusions4d_torch in place of the JAX package):
each anchor's synthetic scene is regenerated from its gen.json by the port's
own generator, the committed eval_argv runs through
occlusions4d_torch.evaluate.test_driver.main(args, device='cpu') (the kernels'
plain versions) over the first 3 steps of the committed run, and

  * the evaluated prefix clears the anchor's learned-quality floors
    (tests/test_anchor.py::_FLOORS);
  * every per-frame metric reproduces the committed metrics.json within
    max(0.02, 3%) of the committed value.
'''

import numpy as np
import pytest
import torch

import anchor_recipe
from anchor_recipe import EVAL_STEPS, FLOORS

torch.set_num_threads(2)


@pytest.fixture(scope='module', params=['greater', 'carla'])
def anchor_eval(request, tmp_path_factory):
    from occlusions4d_torch.config import test_args as parse_test_args
    from occlusions4d_torch.evaluate import test_driver

    dataset = request.param
    root = tmp_path_factory.mktemp(f'torch_anchor_{dataset}')
    data = anchor_recipe.make_scene(dataset, root)
    argv, committed = anchor_recipe.eval_argv(dataset, data, root / 'logs' / 'anchor')
    args = parse_test_args(argv)
    summary = test_driver.main(args, device='cpu')
    assert len(summary['per_frame']) == EVAL_STEPS
    return dataset, summary, committed


def test_torch_anchor_model_learned(anchor_eval):
    dataset, summary, _ = anchor_eval
    floors, mean = FLOORS[dataset], summary['mean']
    assert mean['occupancy_f1'] > floors['occupancy_f1'], mean
    assert mean['occupancy_precision'] > floors['occupancy_precision'], mean
    assert mean['occupancy_recall'] > floors['occupancy_recall'], mean
    assert np.isfinite(mean['chamfer']) and mean['chamfer'] < floors['chamfer_max'], mean
    if 'segmentation_acc' in floors:
        assert mean['segmentation_acc'] > floors['segmentation_acc'], mean
    if 'tracking_precision' in floors:
        assert mean['tracking_precision'] > floors['tracking_precision'], mean
        assert mean['tracking_recall'] > floors['tracking_recall'], mean


def test_torch_anchor_metrics_reproduce(anchor_eval):
    _, summary, committed = anchor_eval
    assert len(committed['per_frame']) > len(summary['per_frame'])
    for got_f, ref_f in zip(summary['per_frame'], committed['per_frame']):
        assert sorted(got_f) == sorted(ref_f)
        for key, ref in ref_f.items():
            got = got_f[key]
            assert abs(got - ref) <= max(0.02, 0.03 * abs(ref)), (key, got, ref)
