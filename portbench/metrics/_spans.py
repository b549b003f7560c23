'''Readers of the program's own spans (occlusions4d_torch/utils/profiling.py):
a span's device time (CUDA events at its start and end, on the card's
clock) summed over the traced window, over the window's items. The window's
items are the last data['items'] items (root spans: a step or a scene) in
the program's store, so spans an earlier window left there count for
nothing. None where the span was not recorded, or where the program has no
such spans.'''


def dev_ms_per_item(data, name):
    n = data.get('items')
    if not n:
        return None
    try:
        from occlusions4d_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, 'spans', None)
    if spans is None:
        return None
    if '_span_ms' not in data:   # one resolution for all the readers.
        rows = spans()
        window = set(sorted({r['item'] for r in rows if r['item'] is not None})[-n:])
        ms = {}
        for r in rows:
            if r['item'] in window:
                a, b = r['device_ms']
                ms[r['name']] = ms.get(r['name'], 0.0) + (b - a)
        data['_span_ms'] = ms
    total = data['_span_ms'].get(name)
    return None if total is None else total / n
