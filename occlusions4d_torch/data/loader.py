'''
Batching + double-buffered prefetch, and the loader factory that picks GREATER vs
CARLA by path (own copy of occlusions4d_tpu/data/loader.py).

A background prefetch thread assembles fixed-shape numpy batches while the
device computes; the host only needs to stay ahead of one step. The batches are
numpy (the consumer moves them to the card), bit for bit the JAX package's.
create_train_val_loaders waits for the port's train driver.
'''

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .greater import GreaterDataset
from .carla import CarlaDataset

__all__ = ['Loader', 'collate', 'create_test_loader']

_STACK_KEYS = ('pcl_input', 'pcl_input_sem', 'pcl_target', 'pcl_target_valid',
               'valo_ids', 'num_valo_ids', 'cam_RT', 'cam_K', 'rgb', 'depth',
               'flat', 'snitch')


def collate(examples):
    '''Stack array fields; collect meta_data dicts in a list.'''
    batch = {}
    for key in _STACK_KEYS:
        if key in examples[0]:
            batch[key] = np.stack([ex[key] for ex in examples])
    batch['meta_data'] = [ex['meta_data'] for ex in examples]
    return batch


class Loader:
    '''Epoch-based iterable with shuffling, drop_last, and prefetch.

    num_workers > 1 decodes examples through a thread pool: the hot host ops
    (C++ FPS / kNN / frame decode via ctypes, zlib inflate, most numpy)
    release the GIL. (The JAX package's fork-based process workers serve its
    train loaders only; the port has none yet.) Per-example RNG is derived
    from (seed, epoch, index), so the produced batches are bit-identical
    across worker counts, and batches are always yielded in index order
    regardless of worker completion order.
    '''

    def __init__(self, dataset, batch_size, shuffle=True, drop_last=True,
                 prefetch=2, seed=0, num_workers=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.seed = seed
        self.num_workers = num_workers

    @property
    def steps_per_epoch(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch_idx=0):
        if hasattr(self.dataset, 'set_epoch'):
            self.dataset.set_epoch(epoch_idx)  # per-(seed, epoch, index) RNG streams.
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch_idx).shuffle(order)
        steps = self.steps_per_epoch
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def batches():
            for s in range(steps):
                idxs = order[s * self.batch_size:(s + 1) * self.batch_size]
                if len(idxs) < self.batch_size and self.drop_last:
                    return
                yield idxs

        def producer_serial():
            for idxs in batches():
                if stop.is_set():
                    return
                q.put(collate([self.dataset[int(i)] for i in idxs]))

        def producer_pool():
            window = self.num_workers + self.prefetch * self.batch_size
            pool = ThreadPoolExecutor(self.num_workers)
            submit = lambda i: pool.submit(self.dataset.__getitem__, i)  # noqa: E731
            try:
                pending = collections.deque()   # (batch_futures) in order.
                batch_iter = iter(batches())
                inflight = 0

                def refill():
                    nonlocal inflight
                    while inflight < window:
                        idxs = next(batch_iter, None)
                        if idxs is None:
                            return False
                        futs = [submit(int(i)) for i in idxs]
                        pending.append(futs)
                        inflight += len(futs)
                    return True

                refill()
                while pending and not stop.is_set():
                    futs = pending.popleft()
                    q.put(collate([f.result() for f in futs]))
                    inflight -= len(futs)
                    refill()
            finally:
                pool.shutdown(wait=False, cancel_futures=True)

        def producer():
            try:
                if self.num_workers > 1:
                    producer_pool()
                else:
                    producer_serial()
            except Exception as e:  # surface loader errors to the consumer.
                q.put(e)
            finally:
                q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def _train_dset_args(cfg, data_kind, logger):
    '''The dataset arguments a train configuration gives (the JAX package's
    dset_args, which its checkpoints carry).'''
    n_target = -int(max(abs(cfg.n_points), abs(cfg.n_data_rnd)) * 2)
    base = dict(
        video_length=cfg.video_len, frame_skip=cfg.frame_skip,
        n_points_rnd=cfg.n_data_rnd, n_fps_input=cfg.n_points,
        n_fps_target=n_target,
        pcl_input_frames=cfg.video_len - cfg.future_frames,
        pcl_target_frames=cfg.past_frames + cfg.future_frames,
        sample_bias=cfg.sample_bias, sb_occl_frame_shift=cfg.sb_occl_frame_shift,
        min_z=cfg.min_z, other_bounds=cfg.pt_cube_bounds,
        use_data_frac=cfg.use_data_frac, verbose='dbg' in cfg.name,
        return_images=getattr(cfg, 'export_visuals', False))
    if data_kind == 'carla':
        reference_frame = (cfg.video_len - cfg.future_frames - 1
                           if cfg.correct_ego_motion else None)
        base.update(reference_frame=reference_frame,
                    correct_origin_ground=cfg.correct_origin_ground,
                    target_bounds=cfg.cr_cube_bounds, cube_mode=cfg.cube_mode,
                    oversample_vehped_target=cfg.oversample_vehped_target,
                    # GREATER-style random-instance track supervision when
                    # the tracking objective is on (the JAX package's
                    # extension of the dataset's zero marks).
                    track_mode='random' if cfg.tracking_lw > 0.0 else 'none')
    else:
        assert cfg.sample_bias in ('none', 'occl')
        base.update(convert_to_pcl=True, return_segm=True,
                    track_mode='random' if cfg.tracking_lw > 0.0 else 'none')
    return base


def create_test_loader(cfg, dset_args, logger):
    '''Test loader with checkpoint-stored dset_args + test-time overrides.'''
    dset_args = dict(dset_args)
    dset_args['ss_frame_step'] = cfg.ss_frame_step
    dset_args['n_fps_target'] = 0
    dset_args['use_data_frac'] = cfg.use_data_frac
    dset_args['sample_bias'] = cfg.sample_bias
    dset_args['sb_occl_frame_shift'] = cfg.sb_occl_frame_shift
    dset_args['verbose'] = 'dbg' in cfg.name
    dset_args['use_json'] = cfg.use_json

    # The loader's workers are threads (verify_args refuses worker_mode
    # 'process': load_models has started the CUDA runtime before this loader
    # exists, and a fork after that is a hazard). A train checkpoint's
    # dset_args may carry the JAX package's process-worker shared_counters.
    dset_args.pop('shared_counters', None)

    data_kind = 'carla' if 'carla' in cfg.data_path.lower() else 'greater'
    if data_kind == 'carla':
        dset_args['oversample_vehped_target'] = False
        # Same test-time semantics as GREATER: 'all' is handled by inference
        # reruns, so the dataset itself must not mark (stored train dset_args
        # may carry track_mode='random').
        if cfg.track_mode in ('none', 'all'):
            dset_args['track_mode'] = 'none'
        dset = CarlaDataset(cfg.data_path, logger, stage='test', seed=cfg.seed,
                            **dset_args)
    else:
        assert cfg.sample_bias in ('none', 'occl')
        dset_args['force_view_idx'] = cfg.force_view_idx
        if cfg.track_mode in ('none', 'all'):
            dset_args['track_mode'] = 'none'  # 'all' is handled by inference reruns.
        dset = GreaterDataset(cfg.data_path, logger, stage='test', seed=cfg.seed,
                              **dset_args)
    loader = Loader(dset, 1, shuffle=False, drop_last=False, seed=cfg.seed,
                    num_workers=cfg.num_workers)
    return data_kind, loader
