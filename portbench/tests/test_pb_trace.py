'''Idle share and span attribution on a small synthetic Chrome trace.'''

import pytest

from portbench import trace
from portbench.metrics import _share


def _ev(name, cat, ts, dur, tid=1, **args):
    return dict(name=name, cat=cat, ph='X', ts=ts, dur=dur, pid=1, tid=tid, args=args)


def synthetic():
    # Window 0-1100 us; device busy 100-300 (attn), 250-400 (overlaps: gemm),
    # 700-900 (attn_bwd); idle 0-100, 400-700, 900-1100.
    return [
        _ev('portbench_window', 'user_annotation', 0, 1100),
        _ev('o4d_attn', 'user_annotation', 10, 20),
        _ev('cudaLaunchKernel', 'cuda_runtime', 12, 5, correlation=1),
        _ev('aten::mm', 'cpu_op', 40, 10),
        _ev('cudaLaunchKernel', 'cuda_runtime', 42, 5, correlation=2),
        _ev('o4d_attn_bwd', 'user_annotation', 500, 40),
        _ev('cudaLaunchKernel', 'cuda_runtime', 510, 5, correlation=3),
        _ev('aten::copy_', 'cpu_op', 450, 200),
        _ev('attn_tile_kernel', 'kernel', 100, 200, tid=7, correlation=1),
        _ev('gemm', 'kernel', 250, 150, tid=7, correlation=2),
        _ev('gemm3_kernel', 'kernel', 700, 200, tid=7, correlation=3),
    ]


def test_busy_idle_and_spans():
    r = trace.reduce_trace(synthetic(), 'portbench_window')
    assert r['window_s'] == pytest.approx(1100e-6)
    assert r['busy_s'] == pytest.approx(500e-6)        # 100-400 and 700-900.
    assert r['span_s'] == pytest.approx({'o4d_attn': 200e-6, 'o4d_attn_bwd': 200e-6})
    assert trace.span_seconds(r['span_s'], ('attn_bwd', 'attn_g_bwd')) == pytest.approx(200e-6)
    assert r['device_ops'][0][0] in ('attn_tile_kernel', 'gemm3_kernel')
    gaps = dict((round(s * 1e6), name) for name, s in r['idle_gaps'])
    assert gaps == {100: 'aten::mm',                   # 0-100: the host in a product.
                    300: 'aten::copy_',                # 400-700: the host copied.
                    200: 'after aten::copy_'}          # 900-1100: Python after it.
    assert _share.idle_pct(dict(trace=r)) == pytest.approx(100.0 * 600 / 1100)


def test_roofline_and_mfu_arithmetic():
    data = dict(items=2, config=dict(precision='f32'),
                peaks=dict(flops_per_s=dict(f32=100.0), bytes_per_s=10.0),
                flops_per_item=50.0, trace=dict(window_s=4.0, busy_s=3.0))
    # 2 items x (100 operations at 100/s, 5 bytes at 10/s): bound 2 s of 8 s.
    assert _share.roofline_pct((100.0, 5.0), 8.0, data) == pytest.approx(25.0)
    assert _share.roofline_pct((100.0, 5.0), 0.0, data) is None
    assert _share.mfu_pct(data) == pytest.approx(100.0 * 100.0 / (4.0 * 100.0))
