'''The whole scene's model operations (work/<config>.py) over the traced
window's wall time, as a percent of the card's peak at the configuration's
precision.'''

from portbench.metrics._share import mfu_pct


def read(data):
    return mfu_pct(data)
