'''
Phase timing of host loops (own copy of occlusions4d_tpu/utils/profiling.py's
PhaseTimer; its device_trace and annotate wait for the port's observability
work).

PhaseTimer accumulates wall-clock per named phase (data / dispatch / fetch /
metrics / export ...). It measures the host's view: CUDA launches return
before the device finishes, so a phase that launches kernels counts only
their dispatch unless it synchronizes (a copy to the host does).
'''

import contextlib
import time
from collections import defaultdict

__all__ = ['PhaseTimer']


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
