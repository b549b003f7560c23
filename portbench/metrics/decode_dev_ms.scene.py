'''The decoder over every query of a dense scene, in chunks (the program's
span scene.decode, inside InferenceEngine.decode_all): its device ms a
traced scene.'''

from portbench.metrics._spans import dev_ms_per_item


def read(data):
    return dev_ms_per_item(data, 'scene.decode')
