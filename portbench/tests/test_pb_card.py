'''On the card (skipped without one): one seed of each cell at its own size,
the program's numbers within their limits and the TF32 control's outside
one of them (python -m pytest portbench/tests -q -m cuda).'''

import time

import pytest

from portbench import calibrate, compare, registry
from portbench.run import context


@pytest.mark.cuda
@pytest.mark.parametrize('cell', ['gv1.train', 'cv1.scene', 'cv1.train', 'gv1.scene'])
def test_program_within_and_control_outside(cuda, cell):
    bench = registry.benchmark()
    ctx = context(bench, registry.cell(bench, cell), 2 ** 31 + 101, 0.0, 0, cuda.device,
                  time.time())
    read = (calibrate.train_readings if ctx.mix['driver'] == 'train'
            else calibrate.scene_readings)(ctx, {'control'})
    assert compare.checks(read['program'], ctx.limits)[1]
    assert not compare.checks(read['control'], ctx.limits)[1]
