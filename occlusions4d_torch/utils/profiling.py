'''
Spans, counters, phase timing and device traces (own copy of
occlusions4d_tpu/utils/profiling.py, over torch.profiler where the JAX
package has jax.profiler):

  * span(name, tile=False, root=False): a named span at a layer boundary.
    Off (the default) it is one check and a shared null context. On, it
    keeps in memory (span_totals, spans): its host interval
    (time.perf_counter_ns), its parent (the innermost open span on the same
    thread), the item it belongs to (the step or scene: a root=True span
    starts one, its descendants share its id), and a CUDA event at its start
    and end on the current stream, so that its device interval is on the
    card's clock (the host interval where CUDA is not initialised). While a
    device trace records it is also a torch.profiler.record_function, so the
    trace shows it on the host and, around what it launched, on the card.
    Events are resolved only when read: recording never synchronizes.
    A tiled span (tile=True) starts where its previous tiled sibling ended,
    or where its parent started if it is the first: its start event is that
    span's end event, so the device intervals of tiled siblings sum to the
    parent's, and the time the card waits for the host belongs to the span
    in which it waits.
  * begin(name, tile=False, root=False) / end(s) / within(s): a span opened
    and closed apart, on any thread (begin returns None when off). It is not
    on a thread's stack unless within(s) puts it there for a block, and it
    takes no record_function (the autograd engine's thread or a post worker
    may end it).
  * count(name, n=1): a counter at the same boundaries, in the same store.
  * Recording is on while a device trace records (torch.profiler, as
    start_trace / stop_trace below start it) or after record_spans(True).
    The store is emptied when recording starts from off (record_spans(True),
    or start_trace, with neither on), and keeps the last MAX_SPANS closed
    spans, so a recording left on holds a bounded number of spans and CUDA
    events. A trace started by another torch.profiler caller empties
    nothing: mark() before a window and since= after it read that window
    alone, as root spans' item ids do.
    span_totals() -> {name: dict(calls, host_ms, device_ms, self_ms)}
    (self: device ms less the part that the span's children cover);
    counters(); spans() (each span resolved); reset_spans(); spans_table()
    and write_spans(path) (span_totals and counters as JSON); each reader
    takes since=mark() for what closed after the mark.
  * PhaseTimer accumulates wall-clock per named phase (the evaluation
    loop's data / dispatch / fetch / metrics / export ...). It measures
    the host's view: CUDA launches return before the device finishes.
  * start_trace(log_dir) / stop_trace(): one torch.profiler recording of
    the CPU and, where CUDA is available, the card (kernels, copies and the
    gpu_user_annotation spans around them), written on stop as a Chrome /
    TensorBoard trace (<host>_<pid>.<time>.pt.trace.json) under log_dir;
    the counterparts of jax.profiler.start_trace / stop_trace, as the train
    loop's --profile_steps uses them.
  * device_trace(log_dir, enabled=True): the same as a context manager; a
    no-op when enabled is false or log_dir is empty.
  * annotate(name): span(name), the JAX package's name. Every kernel
    wrapper launches inside a span o4d_<kernel> (ops/_build.py::span); a
    layer span's name never starts with o4d_.
'''

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque

import torch

__all__ = ['PhaseTimer', 'device_trace', 'annotate', 'start_trace', 'stop_trace', 'span',
           'begin', 'end', 'within', 'count', 'record_spans', 'mark', 'span_totals',
           'counters', 'spans', 'reset_spans', 'spans_table', 'write_spans', 'MAX_SPANS']

MAX_SPANS = 1 << 16     # closed spans kept (a gv1 step closes about 60).


# ---------------------------------------------------------------- spans --

class _Store:
    '''The process's closed spans and counters.'''

    def __init__(self):
        self.on = False                 # record_spans(True).
        self.lock = threading.Lock()
        self.closed = deque(maxlen=MAX_SPANS)
        self.n_closed = 0               # spans closed so far (never reset): their seq.
        self.counts = defaultdict(int)
        self.items = itertools.count()
        self.local = threading.local()  # .stack: the thread's open spans.

    def stack(self):
        st = getattr(self.local, 'stack', None)
        if st is None:
            st = self.local.stack = []
        return st


_STORE = _Store()
_NULL = contextlib.nullcontext()


def _recording():
    return _STORE.on or torch.autograd._profiler_enabled()


def record_spans(on=True):
    '''Record spans and counters with no device trace (for an operator, or
    to time what recording costs); turned on from off, it empties the store.'''
    if on and not _recording():
        reset_spans()
    _STORE.on = bool(on)


class _Mark:
    __slots__ = ('seq', 'counts')

    def __init__(self, seq, counts):
        self.seq, self.counts = seq, counts


def mark():
    '''The store's position now, for the readers' since=.'''
    with _STORE.lock:
        return _Mark(_STORE.n_closed, dict(_STORE.counts))


class _Span:
    __slots__ = ('name', 'parent', 'item', 'tile', 'tid', 't0', 't1', 'ev0', 'ev1',
                 'last', 'rf', 'stack', 'seq')

    def __init__(self, name, tile, parent):
        self.name = name
        self.tile = tile
        self.parent = parent
        self.last = None                # the last closed tiled child.
        self.rf = self.stack = self.t1 = self.ev1 = None

    def open(self, root, trace):
        p = self.parent
        self.item = next(_STORE.items) if root else (p.item if p is not None else None)
        self.tid = threading.get_ident()
        if self.tile and p is not None and p.last is not None:
            self.t0, self.ev0 = p.last.t1, p.last.ev1       # where the last tile ended.
        elif self.tile and p is not None:
            self.t0, self.ev0 = p.t0, p.ev0                 # the first tile: the parent's start.
        else:
            self.t0 = time.perf_counter_ns()
            self.ev0 = _event()
        if trace and torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def close(self):
        self.ev1 = _event()
        self.t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        if self.stack is not None:
            self.stack.remove(self)
            self.stack = None
        if self.tile and self.parent is not None:
            self.parent.last = self
        with _STORE.lock:
            self.seq = _STORE.n_closed
            _STORE.n_closed += 1
            _STORE.closed.append(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _event():
    '''A timing event recorded on the current stream, or None where CUDA is
    not initialised (no device work can be pending).'''
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def span(name, tile=False, root=False):
    '''A span around a block (module docstring); root=True starts an item.
    :return a context manager (the span itself when recording).'''
    if not _recording():
        return _NULL
    st = _STORE.stack()
    s = _Span(name, tile, st[-1] if st else None).open(root, trace=True)
    st.append(s)
    s.stack = st
    return s


def begin(name, tile=False, root=False, parent=None):
    '''A span opened now and closed by end(s), on this or another thread;
    its parent is `parent` or the innermost open span on this thread.
    :return the span, or None when not recording.'''
    if not _recording():
        return None
    if parent is None:
        st = _STORE.stack()
        parent = st[-1] if st else None
    return _Span(name, tile, parent).open(root, trace=False)


def end(s):
    '''Close a span of begin() (None: nothing).'''
    if s is not None:
        s.close()


class _Within:
    __slots__ = ('span', 'stack')

    def __init__(self, s):
        self.span = s

    def __enter__(self):
        self.stack = _STORE.stack()
        self.stack.append(self.span)
        return self.span

    def __exit__(self, *exc):
        self.stack.remove(self.span)


def within(s):
    '''Spans opened on this thread in the block are children of s (a span of
    begin(), or None: nothing).'''
    return _NULL if s is None else _Within(s)


def count(name, n=1):
    '''Add n to a counter, while recording.'''
    if _recording():
        with _STORE.lock:
            _STORE.counts[name] += n


annotate = span


def reset_spans():
    '''Drop the closed spans and the counters.'''
    with _STORE.lock:
        _STORE.closed.clear()
        _STORE.counts.clear()


def counters(since=None):
    '''{name: count}, or what each counted after a mark().'''
    with _STORE.lock:
        counts = dict(_STORE.counts)
    if since is not None:
        counts = {k: v - since.counts.get(k, 0) for k, v in counts.items()}
        counts = {k: v for k, v in counts.items() if v}
    return counts


def _union(intervals, lo, hi):
    '''Length of the union of [a, b] intervals clipped to [lo, hi].'''
    total, cur = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, cur), min(b, hi)
        if b > a:
            total += b - a
            cur = b
    return total


def spans(since=None):
    '''Every closed span (or those closed after a mark()) in the order
    closed, resolved (this waits for
    their events): dict(name, parent (index into the list, or None), item,
    tid, host_ms (start, end) and device_ms (start, end), both from the
    first span's host start, clock: the card whose events give device_ms,
    or 'host' where the span has none and device_ms is its host interval).'''
    with _STORE.lock:
        closed = list(_STORE.closed)
    if since is not None:
        closed = [s for s in closed if s.seq >= since.seq]
    if not closed:
        return []
    index = {id(s): i for i, s in enumerate(closed)}
    base = min(s.t0 for s in closed)
    refs = {}   # device -> (its earliest start event, that span's host ms).
    for s in sorted(closed, key=lambda s: s.t0):
        if s.ev1 is not None:
            s.ev1.synchronize()
        if s.ev0 is not None and s.ev0.device not in refs:
            refs[s.ev0.device] = (s.ev0, (s.t0 - base) / 1e6)
    out = []
    for s in closed:
        host = ((s.t0 - base) / 1e6, (s.t1 - base) / 1e6)
        dev, clock = host, 'host'
        if s.ev0 is not None and s.ev1 is not None and s.ev0.device == s.ev1.device:
            ref, origin = refs[s.ev0.device]
            dev = (origin + ref.elapsed_time(s.ev0), origin + ref.elapsed_time(s.ev1))
            clock = str(s.ev0.device)
        out.append(dict(name=s.name, parent=index.get(id(s.parent)), item=s.item, tid=s.tid,
                        host_ms=host, device_ms=dev, clock=clock))
    return out


def span_totals(since=None):
    '''{name: dict(calls, host_ms, device_ms, self_ms)} over the closed
    spans, or those closed after a mark() (self_ms: device ms less the part
    its children's device intervals on the same clock cover).'''
    rows = spans(since)
    children = defaultdict(list)
    for r in rows:
        p = r['parent']
        if p is not None and rows[p]['clock'] == r['clock']:
            children[p].append(r['device_ms'])
    out = {}
    for i, r in enumerate(rows):
        t = out.setdefault(r['name'], dict(calls=0, host_ms=0.0, device_ms=0.0, self_ms=0.0))
        a, b = r['device_ms']
        t['calls'] += 1
        t['host_ms'] += r['host_ms'][1] - r['host_ms'][0]
        t['device_ms'] += b - a
        t['self_ms'] += (b - a) - _union(children.get(i, ()), a, b)
    return out


def spans_table(totals=None, counts=None):
    '''span_totals() and counters() as text, a line each.'''
    totals = span_totals() if totals is None else totals
    counts = counters() if counts is None else counts
    lines = [f'{"span":<28} {"calls":>6} {"host ms":>11} {"device ms":>11} {"self ms":>11}']
    for name, t in sorted(totals.items(), key=lambda kv: -kv[1]['device_ms']):
        lines.append(f'{name:<28} {t["calls"]:>6} {t["host_ms"]:>11.3f} '
                     f'{t["device_ms"]:>11.3f} {t["self_ms"]:>11.3f}')
    lines += [f'{name:<28} {n:>6}' for name, n in sorted(counts.items())]
    return '\n'.join(lines)


def write_spans(path, since=None):
    '''Write dict(spans=span_totals(since), counters=counters(since)) as
    JSON to path. :return (totals, counters).'''
    totals, counts = span_totals(since), counters(since)
    with open(path, 'w') as f:
        json.dump(dict(spans=totals, counters=counts), f, indent=1, sort_keys=True)
    return totals, counts


# ----------------------------------------------------------- phase timer --

class PhaseTimer:
    '''Accumulates wall time per named phase across a loop.'''

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def summary(self):
        '''name -> (total_s, count, mean_ms) sorted by total descending.'''
        out = {}
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            tot = self.totals[name]
            cnt = max(self.counts[name], 1)
            out[name] = (tot, self.counts[name], tot / cnt * 1000.0)
        return out

    def report(self, logger=None, prefix=''):
        lines = [f'{prefix}{n}: {tot:.2f}s total, {cnt} calls, {ms:.1f} ms/call'
                 for n, (tot, cnt, ms) in self.summary().items()]
        text = '\n'.join(lines)
        if logger is not None:
            logger.info('Phase timing:\n' + text)
        return text

    def reset(self):
        self.totals.clear()
        self.counts.clear()


# ---------------------------------------------------------------- traces --

_ACTIVE = None   # the recording torch.profiler.profile, one a process.


def start_trace(log_dir):
    '''Start recording a device trace to be written under log_dir (made if
    missing). Raises RuntimeError while another trace records.'''
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError('a device trace is already recording')
    if not _recording():     # recording starts: the store is emptied.
        reset_spans()
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    _ACTIVE = prof


def stop_trace():
    '''Stop the recording trace and write it. :return the profile.'''
    global _ACTIVE
    prof, _ACTIVE = _ACTIVE, None
    if prof is None:
        raise RuntimeError('no device trace is recording')
    prof.stop()
    return prof


@contextlib.contextmanager
def device_trace(log_dir, enabled=True):
    '''A device trace of the block, written under log_dir (viewable in
    TensorBoard's profiler plugin, Perfetto or chrome://tracing).'''
    if not enabled or not log_dir:
        yield
        return
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()
