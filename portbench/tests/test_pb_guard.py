'''The import guard, and the command's refusal without a card.'''

import os
import subprocess
import sys

from portbench import guard
from portbench.registry import ROOT


def test_names_are_compared_whole():
    mods = dict.fromkeys(['occlusions4d_torch', 'occlusions4d_torch.train', 'jaxtyping',
                          'flaxen', 'numpy', 'portbench.run'])
    assert guard.forbidden_modules(mods) == []
    mods.update(dict.fromkeys(['jaxlib.xla_client', 'occlusions4d_tpu.ops', 'optax']))
    assert guard.forbidden_modules(mods) == ['jaxlib', 'occlusions4d_tpu', 'optax']


def test_the_benchmark_and_the_port_load_no_jax():
    code = ('import portbench.run, portbench.calibrate, portbench.drivers.train, '
            'portbench.drivers.scene, occlusions4d_torch.train, '
            'occlusions4d_torch.evaluate.inference\n'
            'from portbench import guard\nprint(guard.forbidden_modules())')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run([sys.executable, '-m', 'portbench', '--workload', 'gv1.train',
                          '--seed', str(2 ** 31 + 3), '--seconds', '1', '--trace', '0'],
                         cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
    assert 'CUDA card' in out.stderr
