'''The outputs' copies to the host (the program's span scene.fetch, in
finish_inference): its device ms a traced scene.'''

from portbench.metrics._spans import dev_ms_per_item


def read(data):
    return dev_ms_per_item(data, 'scene.fetch')
