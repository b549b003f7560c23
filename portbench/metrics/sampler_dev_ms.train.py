'''The query sampler of every frame (the program's span train.sampler):
its device ms a traced step.'''

from portbench.metrics._spans import dev_ms_per_item


def read(data):
    return dev_ms_per_item(data, 'train.sampler')
