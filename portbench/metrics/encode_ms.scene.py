'''The encoder of a dense scene: CUDA events around InferenceEngine.encode,
the mean over the traced scenes.'''


def read(data):
    t = data['events_ms']['encode']
    return sum(t) / len(t) if t else None
