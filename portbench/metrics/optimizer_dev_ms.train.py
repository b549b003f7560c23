'''The update: clip, AdamW, the guards and the batch statistics (the
program's span train.optimizer): its device ms a traced step.'''

from portbench.metrics._spans import dev_ms_per_item


def read(data):
    return dev_ms_per_item(data, 'train.optimizer')
