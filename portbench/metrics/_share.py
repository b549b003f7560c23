'''Arithmetic the per-layer readers share: a roofline share and an mfu.'''


def bound_s(flops, nbytes, data):
    '''The least time the card could take: the larger of the operations at
    the configuration's precision's peak and the bytes at the memory's.'''
    peaks = data['peaks']
    return max(flops / peaks['flops_per_s'][data['config']['precision']],
               nbytes / peaks['bytes_per_s'])


def roofline_pct(work_per_item, seconds, data):
    '''Percent of the bound that the device time under the kernel's spans
    reaches, over the traced window's items; None without such time.'''
    if seconds <= 0:
        return None
    flops, nbytes = work_per_item
    n = data['items']
    return 100.0 * bound_s(n * flops, n * nbytes, data) / seconds


def mfu_pct(data):
    '''Percent of the peak that the model's operations over the traced
    window's items reach in the window's wall time.'''
    window = data['trace']['window_s']
    if window <= 0:
        return None
    peak = data['peaks']['flops_per_s'][data['config']['precision']]
    return 100.0 * data['items'] * data['flops_per_item'] / (window * peak)


def idle_pct(data):
    t = data['trace']
    if t['window_s'] <= 0:
        return None
    return 100.0 * (t['window_s'] - t['busy_s']) / t['window_s']
