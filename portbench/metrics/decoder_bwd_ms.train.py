'''The decoder's backward in one phase-split step after the traced window
(Trainer.step's marks with a synchronize at each): from the losses queued
to the gradient reaching the abstract cloud.'''


def read(data):
    return data['phase_ms'].get('decoder_backward')
