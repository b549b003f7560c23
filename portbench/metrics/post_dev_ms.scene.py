'''The host's track merge, density split and compress_air (the program's
span scene.post, in finish_inference): its device ms a traced scene, the
card idle unless the next scene's work is queued.'''

from portbench.metrics._spans import dev_ms_per_item


def read(data):
    return dev_ms_per_item(data, 'scene.post')
