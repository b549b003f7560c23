'''
The committed anchors' eval recipe for the port's driver, one copy for
tests/test_torch_anchor.py, tests/test_torch_cuda.py and chip_smoke.py:
tests/test_anchor.py's learned-quality floors and step count, its scene (made
again from gen.json, here by the port's data/synthetic.py) and its argument
list (the committed eval_argv, the frame fraction that leaves the steps,
--data_path, --resume tests/assets/<anchor>, --log_path). Imports nothing of
JAX.
'''

import json
import os

from test_anchor import _EVAL_STEPS, _FLOORS

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'assets')
# Asset folder per dataset kind (tests/test_anchor.py's params).
ANCHORS = dict(greater='anchor', carla='anchor_carla')

__all__ = ['ASSETS', 'ANCHORS', 'EVAL_STEPS', 'FLOORS', 'load', 'make_scene', 'eval_argv']

EVAL_STEPS = _EVAL_STEPS
FLOORS = _FLOORS


def load(kind):
    '''(gen.json's dict, the committed metrics.json) of the kind's anchor.'''
    assets = os.path.join(ASSETS, ANCHORS[kind])
    with open(os.path.join(assets, 'gen.json')) as f:
        gen = json.load(f)
    with open(os.path.join(assets, 'metrics.json')) as f:
        committed = json.load(f)
    return gen, committed


def make_scene(kind, root):
    '''The anchor's synthetic scene under `root` (the dataset kind is read
    from the path: the CARLA folder keeps 'carla' in its name).
    :return the dataset folder.'''
    from occlusions4d_torch.data import synthetic
    gen, _ = load(kind)
    kw = {k: v for k, v in gen.items() if k not in ('eval_argv', 'dataset', 'eval_stage')}
    data = os.path.join(str(root), 'data_carla' if kind == 'carla' else 'data')
    fn = synthetic.make_carla_dataset if kind == 'carla' else synthetic.make_greater_dataset
    fn(data, **dict(kw, stages=tuple(kw['stages'])))
    return data


def eval_argv(kind, data, log, extra=(), steps=EVAL_STEPS):
    '''tests/test_anchor.py's argument list over the first `steps` steps of
    the committed run (use_data_frac shrunk so the dataset holds `steps`
    examples; +0.5 keeps int() off the boundary), then `extra`.
    :return (argv, the committed metrics.json).'''
    gen, committed = load(kind)
    argv = gen['eval_argv']
    frac = float(argv[argv.index('--use_data_frac') + 1]) * (steps + 0.5) \
        / len(committed['per_frame'])
    return argv + ['--data_path', os.path.join(data, gen['eval_stage']),
                   '--resume', os.path.join(ASSETS, ANCHORS[kind]),
                   '--use_data_frac', str(frac), '--log_path', str(log), *extra], committed
