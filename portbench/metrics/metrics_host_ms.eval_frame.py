'''The frame's metrics on the host (the program's span scene.metrics, in the
eval loop's post stage: evaluate/metrics.py with its host 1-NN): its host
ms a traced frame, over the window's frames (the last data['items'] root
spans in the program's store). None where the span was not recorded, or
where the program has no such span.'''


def read(data):
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
    rows = spans()
    window = set(sorted({r['item'] for r in rows if r['item'] is not None})[-n:])
    ms = [r['host_ms'][1] - r['host_ms'][0] for r in rows
          if r['name'] == 'scene.metrics' and r['item'] in window]
    return sum(ms) / n if ms else None
