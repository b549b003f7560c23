'''The decoder cross-attention forward's share of its roofline: the bound of
every forward of the traced scenes (work/<config>.py) over the device time
of every operation launched under the port's o4d_attn / o4d_attn_g spans
(and their bf16 forms), whichever route runs.'''

from portbench.metrics._share import roofline_pct
from portbench.trace import span_seconds


def read(data):
    return roofline_pct(data['attn_fwd_per_item'],
                        span_seconds(data['trace']['span_s'], ('attn', 'attn_g')), data)
