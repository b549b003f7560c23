'''The frozen reference against the port's CPU path at tiny widths: a whole
run of each cell through its driver, the program's numbers within limits.'''

import pytest

from portbench import compare, registry


@pytest.mark.parametrize('cell', ['gv1.train', 'cv1.train', 'gv1.scene', 'cv1.scene'])
@pytest.mark.parametrize('trace', [0, 1])
def test_cell_runs_and_agrees(tiny, cell, trace):
    bench, ctx = tiny(cell, trace=trace)
    run = registry.driver(ctx.mix['driver']).run(ctx)
    rows, ok = compare.checks(run['readings'], ctx.limits)
    assert ok, rows
    assert run['attempted'] >= 1 and run['failed'] == 0
    for r in rows:            # the plain versions on both sides: far inside.
        assert r['value'] <= r['limit'] / 10, r
    if trace:
        assert run['layer']['items'] == ctx.mix['trace_steps' if 'train' in cell
                                                else 'trace_scenes']
    else:
        assert set(run['end_to_end']) == {'step_ms' if 'train' in cell else 'scene_ms',
                                          'peak_mem_gib'}
