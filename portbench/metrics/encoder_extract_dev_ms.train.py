'''The encoder's extraction in the train step: each level's kNN graph and
each DownTransition's FPS, kNN and max-pool (the program's span
encoder.extract, tiled with encoder.blocks inside train.encoder): its
device ms a traced step, over the window's steps (the last data['items']
root spans in the program's store). Only the spans under train.encoder
count (a scene's encoder has them too). None where the span was not
recorded, or where the program has no such spans.'''


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
    ms = [r['device_ms'][1] - r['device_ms'][0] for r in rows
          if r['name'] == 'encoder.extract' and r['item'] in window
          and r['parent'] is not None and rows[r['parent']]['name'] == 'train.encoder']
    return sum(ms) / n if ms else None
