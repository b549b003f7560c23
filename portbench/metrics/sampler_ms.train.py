'''The guided sampler in the same phase-split step: from the encoder's
outputs queued to every frame's queries drawn.'''


def read(data):
    return data['phase_ms'].get('sampler')
