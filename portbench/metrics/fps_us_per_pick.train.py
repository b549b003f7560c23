'''The FPS kernel's device time a pick: the device time launched under the
port's o4d_fps / o4d_fps_cluster spans over the traced steps, in us, over
the points FPS keeps in those steps (the configuration's pyramid, every
level, over the batch; the program's counter encoder.fps_picks counts the
same). None where no FPS time was traced.'''

from portbench.work._field import pyramid


def picks_per_step(cfg):
    return cfg['batch_size'] * sum(pyramid(cfg)[1:])


def read(data):
    seconds = sum(v for k, v in data['trace']['span_s'].items() if k.startswith('o4d_fps'))
    if seconds <= 0 or not data.get('items'):
        return None
    return 1e6 * seconds / (data['items'] * picks_per_step(data['config']))
