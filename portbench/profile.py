'''
The traced sub-window of a --trace 1 run: torch.profiler over the host and
the card around one call, inside a host span that bounds the window (the
call ends with a synchronize, so the window holds all of its device work).
The Chrome trace is written under TMPDIR, reduced (trace.py) and deleted.
'''

import os
import tempfile

import torch

from .trace import reduce_file

WINDOW_SPAN = 'portbench_window'


def capture(fn, device):
    '''Run fn() under the profiler. :return (fn's result, the reduced trace).'''
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.device(device).type == 'cuda'
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            result = fn()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix='portbench_', suffix='.trace.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return result, reduce_file(path, WINDOW_SPAN)
    finally:
        os.remove(path)


def span(name):
    """A host span of the benchmark's own around a call into the program,
    recorded only while a trace records (the untraced window pays nothing
    but this check)."""
    import contextlib
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def split_step(trainer, batch, device):
    '''One more Trainer.step with a synchronize at each of its phase marks
    (chip_smoke.py::split_step): {phase: ms}, in order.'''
    import time

    cuda = torch.device(device).type == 'cuda'

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    marks = [('start', time.time())]

    def mark(name):
        sync()
        marks.append((name, time.time()))

    trainer.step(batch, mark=mark)
    return {n: (t - marks[i][1]) * 1e3 for i, (n, t) in enumerate(marks[1:])}


class CudaTimer:
    '''Wraps a method of an object so that each call is timed by CUDA events
    (the host clock on the CPU); times() gives the ms of each call.'''

    def __init__(self, obj, attr, device):
        import time
        self._time = time.time
        self.obj, self.attr = obj, attr
        self.fn = getattr(obj, attr)
        self.cuda = torch.device(device).type == 'cuda'
        self.pairs = []

    def __call__(self, *args, **kwargs):
        if self.cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = self.fn(*args, **kwargs)
            b.record()
        else:
            a = self._time()
            out = self.fn(*args, **kwargs)
            b = self._time()
        self.pairs.append((a, b))
        return out

    def __enter__(self):
        setattr(self.obj, self.attr, self)
        return self

    def __exit__(self, *exc):
        delattr(self.obj, self.attr)

    def times(self):
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.pairs]
        return [(b - a) * 1e3 for a, b in self.pairs]
