'''The decoder over every query of a dense scene: CUDA events around
InferenceEngine.decode_all, the mean over the traced scenes.'''


def read(data):
    t = data['events_ms']['decode']
    return sum(t) / len(t) if t else None
