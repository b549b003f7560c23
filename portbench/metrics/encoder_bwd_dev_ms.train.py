'''The encoder's backward, from the gradient reaching the abstract cloud to
the backward's end (the program's span train.encoder_bwd): its device ms a
traced step.'''

from portbench.metrics._spans import dev_ms_per_item


def read(data):
    return dev_ms_per_item(data, 'train.encoder_bwd')
