'''The encoder's forward in the train step (the program's span
train.encoder): its device ms a traced step.'''

from portbench.metrics._spans import dev_ms_per_item


def read(data):
    return dev_ms_per_item(data, 'train.encoder')
