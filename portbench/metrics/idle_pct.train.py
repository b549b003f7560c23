'''Share of the traced window in which no operation ran on the card (a
train cell's; trace.py merges the device intervals).'''

from portbench.metrics._share import idle_pct


def read(data):
    return idle_pct(data)
