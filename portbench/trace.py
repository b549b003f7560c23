'''
Reduction of a torch.profiler Chrome trace to what the per-layer metrics
read: the traced window, the device's busy time in it (the union of its
kernels, copies and sets), the device time launched under each of the
port's o4d_<kernel> spans, the device operations that took most time, and
the longest idle gaps, each named by what the host was doing then.

The interval arithmetic follows chip_smoke.py::trace_summary (merged device
intervals). A device operation belongs to a span when the host call that
launched it (its correlation id) ran inside the span on the same thread.
'''

import bisect
import json

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver', 'python_function')


def _x(e, cats):
    return e.get('ph') == 'X' and e.get('cat') in cats


def merge(intervals):
    '''Sorted, merged [start, end] intervals.'''
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(events, window_span, n_top=10):
    '''
    :param events: the trace's traceEvents.
    :param window_span: the name of the host span that bounds the window.
    :return dict(window_s, busy_s, span_s {o4d span name: device seconds},
        device_ops [[name, seconds]], idle_gaps [[host activity, seconds]],
        n_device_ops).
    '''
    win = [e for e in events if e.get('ph') == 'X' and e.get('name') == window_span
           and e.get('cat') == 'user_annotation']
    if not win:
        raise ValueError(f'no span {window_span!r} in the trace')
    w0 = min(float(e['ts']) for e in win)
    w1 = max(float(e['ts']) + float(e['dur']) for e in win)
    dev = []
    for e in events:
        if _x(e, DEVICE_CATS):
            a, b = float(e['ts']), float(e['ts']) + float(e['dur'])
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b, e))
    merged = merge([[a, b] for a, b, _ in dev])
    busy = sum(b - a for a, b in merged)

    # Spans: the launches inside each o4d_ span, by thread, then their ops.
    spans = [e for e in events if _x(e, ('user_annotation',))
             and str(e.get('name', '')).startswith('o4d_')]
    launches = {}
    for e in events:
        if _x(e, LAUNCH_CATS) and 'correlation' in e.get('args', {}):
            launches.setdefault((e.get('pid'), e.get('tid')), []).append(
                (float(e['ts']), e['args']['correlation']))
    for v in launches.values():
        v.sort()
    corr_span = {}
    for s in spans:
        lst = launches.get((s.get('pid'), s.get('tid')), [])
        t0, t1 = float(s['ts']), float(s['ts']) + float(s['dur'])
        for i in range(bisect.bisect_left(lst, (t0, -1)), len(lst)):
            ts, corr = lst[i]
            if ts > t1:
                break
            corr_span[corr] = s['name']
    span_us = {}
    by_name = {}
    for a, b, e in dev:
        name = corr_span.get(e.get('args', {}).get('correlation'))
        if name is not None:
            span_us[name] = span_us.get(name, 0.0) + (b - a)
        by_name[e['name']] = by_name.get(e['name'], 0.0) + (b - a)

    # Idle gaps, named by the innermost host event running at their middle.
    gaps = []
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b > a:
            gaps.append((b - a, a, b))
    gaps.sort(reverse=True)
    gaps = gaps[:n_top]
    host = [e for e in events if _x(e, HOST_CATS) and e.get('name') != window_span]
    named = []
    for g, a, b in gaps:
        mid = (a + b) / 2
        inner = [e for e in host if float(e['ts']) <= mid <= float(e['ts']) + float(e['dur'])]
        if inner:
            label = min(inner, key=lambda e: float(e['dur']))['name']
        else:   # Python between operations: name the last host event before.
            before = [e for e in host if float(e['ts']) + float(e['dur']) <= mid]
            label = ('after ' + max(before, key=lambda e: float(e['ts']) + float(e['dur']))['name']
                     if before else 'host')
        named.append([str(label)[:120], g / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    return dict(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6,
                span_s={k: v / 1e6 for k, v in span_us.items()},
                device_ops=[[n[:120], t / 1e6] for n, t in top],
                idle_gaps=named, n_device_ops=len(dev))


def reduce_file(path, window_span):
    with open(path) as f:
        return reduce_trace(json.load(f)['traceEvents'], window_span)


def span_seconds(span_s, prefixes):
    '''Device seconds under the spans named o4d_<p> or o4d_<p>_bf16 for p in
    prefixes.'''
    names = {f'o4d_{p}' for p in prefixes} | {f'o4d_{p}_bf16' for p in prefixes}
    return sum(v for k, v in span_s.items() if k in names)
