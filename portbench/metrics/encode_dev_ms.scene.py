'''The encoder of a dense scene, its input's copy included (the program's
span scene.encode, inside InferenceEngine.encode): its device ms a traced
scene.'''

from portbench.metrics._spans import dev_ms_per_item


def read(data):
    return dev_ms_per_item(data, 'scene.encode')
