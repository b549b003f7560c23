'''The shape of the result line and of the check's lines.'''

import json
import math

from portbench import run as R


def fake_run(trace, gap=1e-9):
    run = dict(setup_s=12.5, attempted=7, failed=0, memory_peak_bytes=123,
               window_wall_s=20.0, check_s=5.0,
               readings=dict(loss_gap=gap, grad_gap=gap, change_gap=gap))
    if trace:
        run.update(busy_s=1.5, window_s=2.0,
                   breakdown=dict(device_ops=[['k', 1.0]], idle_gaps=[['aten::copy_', 0.1]]),
                   layer=dict(items=2, phase_ms=dict(decoder_backward=1000.0, sampler=30.0),
                              trace=dict(window_s=2.0, busy_s=1.5,
                                         span_s={'o4d_attn_bwd': 0.5}),
                              flops_per_item=1e12, attn_bwd_per_item=(1e12, 1e9)))
    else:
        run['end_to_end'] = dict(step_ms=1500.0, peak_mem_gib=10.5)
    return run


def test_trace0_line(tiny):
    bench, ctx = tiny('gv1.train')
    line, rows = R.result(bench, ctx, fake_run(False), dict(platform='gpu', kind='x', count=1,
                                                            memory_peak_bytes=123))
    assert list(line) == ['correct', 'attempted', 'failed', 'metrics', 'device', 'checks']
    assert line['correct'] is True
    assert set(line['metrics']) == {'step_ms', 'peak_mem_gib', 'setup_s'}
    assert line['metrics']['setup_s'] == dict(value=12.5, unit='s')
    assert list(line['checks']) == list(ctx.limits)
    assert [r['name'] for r in rows] == list(ctx.limits)
    json.loads(json.dumps(line))


def test_trace1_line_and_a_failed_check(tiny):
    bench, ctx = tiny('gv1.train', trace=1)
    line, _ = R.result(bench, ctx, fake_run(True, gap=math.inf), dict(platform='gpu'))
    assert list(line) == ['correct', 'attempted', 'failed', 'metrics', 'device', 'breakdown',
                          'checks']
    assert line['correct'] is False
    assert line['device']['busy_s'] == 1.5 and line['device']['window_s'] == 2.0
    assert set(line['metrics']) == {'idle_pct.train', 'mfu.train', 'attn_bwd_roofline',
                                    'decoder_bwd_ms.train', 'sampler_ms.train'}
    assert line['metrics']['idle_pct.train']['value'] == 25.0
    assert all(c['value'] is None for c in line['checks'].values())
    json.loads(json.dumps(line, allow_nan=False))
