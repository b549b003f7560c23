'''The decoder cross-attention backward's share of its roofline: the bound
of every backward of the traced steps (work/<config>.py: twice the forward's
products; each byte once) over the device time of every operation launched
under the port's o4d_attn_bwd / o4d_attn_g_bwd spans (and their bf16 forms),
whichever route runs.'''

from portbench.metrics._share import roofline_pct
from portbench.trace import span_seconds


def read(data):
    return roofline_pct(data['attn_bwd_per_item'],
                        span_seconds(data['trace']['span_s'], ('attn_bwd', 'attn_g_bwd')), data)
