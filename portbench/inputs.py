'''
The inputs of the traffic mixes, made from the seed on the host, as a
user's data loader hands them over (numpy arrays).

train_batch shapes a batch as the port's synthetic training batches
(chip_smoke.py::train_batch, after bench.py:57-82): a uniform input cloud in
[-1, 1]^8, a target of 2 x n_points points a frame uniform in the output
cube (z folded up), GREATER or CARLA columns, every target point valid.
scene_cloud is one evaluation input: n_points points uniform in the
configuration's blind cuboid, the other seven channels uniform in [-1, 1].
'''

import numpy as np

from .reference.ops import blind_sample_bounds

TRAIN_STREAM = 2
SCENE_STREAM = 3


def train_batch(cfg, data_kind, seed, index, target_factor=2):
    '''Batch `index` of the run's pool: dict of numpy arrays (pcl_input,
    pcl_target, pcl_target_valid, valo_ids, num_valo_ids).'''
    rng = np.random.default_rng([int(seed), TRAIN_STREAM, int(index)])
    B, N = cfg['batch_size'], cfg['n_points']
    T = cfg['past_frames'] + cfg['future_frames']
    M, half = target_factor * N, cfg['cr_cube_bounds']
    E = 9 if data_kind == 'greater' else 11
    tgt = np.zeros((B, T, M, E), np.float32)
    tgt[..., :3] = rng.random((B, T, M, 3), np.float32) * 2.0 * half - half
    tgt[..., 2] = np.abs(tgt[..., 2])
    if data_kind == 'greater':
        tgt[..., 5:8] = rng.random((B, T, M, 3), np.float32)
    else:  # CARLA layout: instance 4, semantics 5, view 6, rgb 7:10.
        tgt[..., 4] = rng.integers(0, 50, (B, T, M))
        tgt[..., 5] = rng.integers(0, 23, (B, T, M))
        tgt[..., 6] = rng.integers(0, 4, (B, T, M))
        tgt[..., 7:10] = rng.random((B, T, M, 3), np.float32)
    R = 32 if data_kind == 'greater' else 256
    return dict(pcl_input=rng.random((B, N, 8), np.float32) * 2 - 1,
                pcl_target=tgt, pcl_target_valid=np.ones((B, T, M), bool),
                valo_ids=np.tile(np.arange(R, dtype=np.int32), (B, 1)),
                num_valo_ids=np.full((B,), 8, np.int32))


def scene_cloud(cfg, data_kind, seed, index):
    '''Input cloud `index` of the run's scenes: (n_points, 8) float32.'''
    rng = np.random.default_rng([int(seed), SCENE_STREAM, int(index)])
    c = blind_sample_bounds(data_kind, cfg['cr_cube_bounds'], cfg['min_z'], cfg['cube_mode'])
    lo = np.array([c.x_min, c.y_min, c.z_min], np.float32)
    hi = np.array([c.x_max, c.y_max, c.z_max], np.float32)
    pcl = rng.random((cfg['n_points'], 8), np.float32) * 2 - 1
    pcl[:, :3] = rng.random((cfg['n_points'], 3), np.float32) * (hi - lo) + lo
    return pcl
