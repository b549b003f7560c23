'''The decoder's forward over every frame and the losses (the program's span
train.decoder_fwd): its device ms a traced step.'''

from portbench.metrics._spans import dev_ms_per_item


def read(data):
    return dev_ms_per_item(data, 'train.decoder_fwd')
