'''The batch's copy to the card in run_epoch (the program's span train.h2d):
its device ms a traced step, which holds the card's wait for the host's
pageable copy and what precedes it in the loop.'''

from portbench.metrics._spans import dev_ms_per_item


def read(data):
    return dev_ms_per_item(data, 'train.h2d')
