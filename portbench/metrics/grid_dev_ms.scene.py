'''The scene's grid queries made on the host and copied to the card (the
program's span scene.grid): its device ms a traced scene.'''

from portbench.metrics._spans import dev_ms_per_item


def read(data):
    return dev_ms_per_item(data, 'scene.grid')
