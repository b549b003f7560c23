'''The decoder's backward, from the backward's start to the gradient reaching
the abstract cloud (the program's span train.decoder_bwd): its device ms a
traced step.'''

from portbench.metrics._spans import dev_ms_per_item


def read(data):
    return dev_ms_per_item(data, 'train.decoder_bwd')
