'''The readers of the program's spans (metrics/_spans.py and the twelve
<layer>_dev_ms metrics): a store filled by hand turns into device ms an
item; a span that was not recorded, or a program without spans, reads None.'''

import time

import pytest

from portbench import registry

SPANS = {'h2d_dev_ms.train': 'train.h2d', 'encoder_dev_ms.train': 'train.encoder',
         'sampler_dev_ms.train': 'train.sampler',
         'decoder_fwd_dev_ms.train': 'train.decoder_fwd',
         'decoder_bwd_dev_ms.train': 'train.decoder_bwd',
         'encoder_bwd_dev_ms.train': 'train.encoder_bwd',
         'optimizer_dev_ms.train': 'train.optimizer', 'grid_dev_ms.scene': 'scene.grid',
         'encode_dev_ms.scene': 'scene.encode', 'decode_dev_ms.scene': 'scene.decode',
         'fetch_dev_ms.scene': 'scene.fetch', 'post_dev_ms.scene': 'scene.post'}


@pytest.fixture
def profiling():
    from occlusions4d_torch.utils import profiling
    profiling.record_spans(False)
    profiling.reset_spans()
    yield profiling
    profiling.record_spans(False)
    profiling.reset_spans()


def test_every_span_metric_is_a_program_span_entry():
    bench = registry.benchmark()
    entries = {m['name']: m for m in bench['per_layer']}
    for name in SPANS:
        m = entries[name]
        assert m['source'] == 'program_span' and m['unit'] == 'ms'
        kind = name.rsplit('.', 1)[1]
        assert m['moves'] == ('step_ms' if kind == 'train' else 'scene_ms')
        assert sorted(m['workloads']) == sorted(w['name'] for w in bench['workloads']
                                                if w['name'].endswith('.' + kind))


def _row(name, item, ms, start=0.0):
    return dict(name=name, parent=None, item=item, tid=0, host_ms=(start, start + 1.0),
                device_ms=(start, start + ms), clock='cuda:0')


@pytest.mark.parametrize('metric', sorted(SPANS))
def test_reader_gives_device_ms_an_item(metric, profiling, monkeypatch):
    read = registry.metric_reader(metric)
    span = SPANS[metric]
    # Items 0-2 are an earlier window's, 3-5 this window's (items=3); a span
    # with no item (the epoch's) and another name count for nothing.
    rows = ([_row(span, i, 1e6) for i in range(3)]
            + [_row(span, i, 10.0 + i) for i in range(3, 6)]
            + [_row(span, 5, 4.5), _row(span, None, 1e6), _row('other', 4, 1e6)])
    monkeypatch.setattr(profiling, 'spans', lambda: rows)
    assert read(dict(items=3)) == pytest.approx((13.0 + 14.0 + 15.0 + 4.5) / 3)
    assert read(dict(items=0)) is None
    monkeypatch.setattr(profiling, 'spans', lambda: [r for r in rows if r['name'] != span])
    assert read(dict(items=3)) is None
    # The parent commit's program has no spans: nothing to read, no raise.
    monkeypatch.delattr(profiling, 'spans')
    assert read(dict(items=3)) is None


def test_reader_reads_recorded_spans(profiling):
    '''Spans recorded through the program's API (on the CPU their device
    interval is the host's): 2 items of at least 20 ms each.'''
    profiling.record_spans(True)
    for _ in range(2):
        with profiling.span('train_step', root=True):
            with profiling.span('train.sampler', tile=True):
                time.sleep(0.02)
    profiling.record_spans(False)
    got = registry.metric_reader('sampler_dev_ms.train')(dict(items=2))
    assert 20.0 <= got < 200.0
    assert registry.metric_reader('decode_dev_ms.scene')(dict(items=2)) is None


def test_reader_reads_the_last_window_alone(profiling):
    '''Two windows recorded in one process with nothing emptied between
    them: the reader sees the second window's items alone.'''
    profiling.record_spans(True)
    for ms in (0.2, 0.02, 0.02):
        with profiling.span('scene', root=True):
            with profiling.span('scene.post', tile=True):
                time.sleep(ms)
    profiling.record_spans(False)
    got = registry.metric_reader('post_dev_ms.scene')(dict(items=2))
    assert 20.0 <= got < 150.0
