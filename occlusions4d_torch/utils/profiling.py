'''
Phase timing and device traces (own copy of occlusions4d_tpu/utils/
profiling.py, over torch.profiler where the JAX package has jax.profiler):

  * PhaseTimer accumulates wall-clock per named phase (data / dispatch /
    fetch / metrics / export ...). It measures the host's view: CUDA
    launches return before the device finishes, so a phase that launches
    kernels counts only their dispatch unless it synchronizes (a copy to
    the host does).
  * start_trace(log_dir) / stop_trace(): one torch.profiler recording of
    the CPU and, where CUDA is available, the card (kernels, copies and the
    gpu_user_annotation spans of the annotations around them), written on
    stop as a Chrome / TensorBoard trace (<host>_<pid>.<time>.pt.trace.json)
    under log_dir; the counterparts of jax.profiler.start_trace /
    stop_trace, as the train loop's --profile_steps uses them.
  * device_trace(log_dir, enabled=True): the same as a context manager; a
    no-op when enabled is false or log_dir is empty.
  * annotate(name): a named span in a trace (torch.profiler.record_function).
    Every kernel wrapper launches inside one named o4d_<kernel> while a
    trace is recording (ops/_build.py::span).
'''

import contextlib
import os
import time
from collections import defaultdict

__all__ = ['PhaseTimer', 'device_trace', 'annotate', 'start_trace', 'stop_trace']


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


_ACTIVE = None   # the recording torch.profiler.profile, one a process.


def start_trace(log_dir):
    '''Start recording a device trace to be written under log_dir (made if
    missing). Raises RuntimeError while another trace records.'''
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError('a device trace is already recording')
    import torch
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


def annotate(name):
    '''Named span visible in device traces.'''
    import torch
    return torch.profiler.record_function(name)
