'''
GREATER dataset reader (RGB-D multi-view, Blender/CATER-like); own copy of
occlusions4d_tpu/data/greater.py, numpy end-to-end, producing fixed-capacity
padded arrays for the device plane:
  * directory layout dataset_root/stage/SCENE/images_viewV/FFFF(.png|_depth.png|
    _preflat.png|_preflat_snitch.png) + poses_viewV/camera_(RT|K).npy + occl.txt;
  * instance ids from preflat hue clusters;
  * RGB-D unprojection + GREATER cuboid/floor filter;
  * random pre-subsample -> time accumulation / view merge -> input FPS to n_points,
    per-frame merged targets randomly subsampled to |n_fps_target| (negative =>
    random mode);
  * occlusion-biased clip selection with a counter board and pinned test-clip JSONs;
  * VALO metadata + snitch/random track marking.

PNGs are decoded by the native fused op (native/png_ops.cpp) or, where it is
not built or cannot serve a file, by data/png.py, the standard-library reader
that takes PIL's place; its pixels go through the same frame pass, so the
frame is bit for bit the same either way.
'''

import json
import os
import pathlib

import numpy as np

from . import common
from .png import imread as _imread  # PIL's / matplotlib's pixels.
from ..ops.bounds import greater_bounds, cuboid_mask, greater_floor_mask
from ..utils.misc import accumulate_pcl_time, merge_pcl_views

__all__ = ['GreaterDataset', 'get_occlusion_rate', 'MAX_DEPTH_CLIP',
           'PREFLAT_HUE_CLUSTERS', 'MAX_VALO_IDS', 'point_cloud_from_rgbd',
           'greater_frame_points']

MAX_DEPTH_CLIP = 32.0
# Known preflat hue cluster centers, degrees.
PREFLAT_HUE_CLUSTERS = [0, 35, 47, 65, 90, 160, 180, 188, 219, 284, 302, 324]
MAX_VALO_IDS = 32


def get_occlusion_rate(scene_dp, src_view):
    '''Snitch occlusion-rate curve from occl.txt.'''
    snitch_occl = np.loadtxt(os.path.join(scene_dp, 'occl.txt'))
    snitch_occl = snitch_occl[src_view]
    frame_step = 3
    rate = np.zeros_like(snitch_occl)
    rate[frame_step:] = snitch_occl[frame_step:] - snitch_occl[:-frame_step]
    return np.clip(rate, 0.0, 1.0)


def _inverse_cams(cam_RT, cam_K):
    '''Inverse camera matrices via the same 4x4 homogeneous inversions the
    original chain used: returns (inv_K (3, 3), inv_RT (3, 4)) float32.'''
    cam_RT_4 = np.eye(4, dtype=np.float32)
    cam_RT_4[:3] = cam_RT
    cam_K_4 = np.eye(4, dtype=np.float32)
    cam_K_4[:3, :3] = cam_K
    return np.linalg.inv(cam_K_4)[:3, :3], np.linalg.inv(cam_RT_4)[:3]


def _unproject(valid_x, valid_y, z, inv_K, inv_RT):
    '''Pixel (x, y, depth) -> world (N, 3) f32, decomposed into elementwise
    ops with a pinned evaluation order so the native fused frame op
    (native/frame_ops.cpp) can reproduce it bit-for-bit: the homogeneous
    chain inv(RT) @ (z * inv(K) @ [x, y, 1]) evaluated per coordinate as
    (((r0*cx + r1*cy) + r2*cz) + t) with cam = ((k0*x + k1*y) + k2) * z.'''
    xs = valid_x.astype(np.float32)
    ys = valid_y.astype(np.float32)
    cam = np.empty((z.shape[0], 3), np.float32)
    for c in range(3):
        d = (inv_K[c, 0] * xs + inv_K[c, 1] * ys) + inv_K[c, 2]
        cam[:, c] = d * z
    world = np.empty_like(cam)
    for c in range(3):
        world[:, c] = ((inv_RT[c, 0] * cam[:, 0] + inv_RT[c, 1] * cam[:, 1])
                       + inv_RT[c, 2] * cam[:, 2]) + inv_RT[c, 3]
    return world


def point_cloud_from_rgbd(rgb, depth, cam_RT, cam_K):
    '''
    RGB-D -> world-space point cloud with attributes, vectorized
   .
    :param rgb (H, W, C) float array (any number of attribute channels).
    :param depth (H, W) float array; zero depth pixels are dropped.
    :return (N, 3 + C) float32 (x, y, z, attrs...).
    '''
    valid_y, valid_x = np.where(depth > 0.0)
    z = depth[valid_y, valid_x].astype(np.float32)
    inv_K, inv_RT = _inverse_cams(cam_RT, cam_K)
    world = _unproject(valid_x, valid_y, z, inv_K, inv_RT)
    attrs = rgb[valid_y, valid_x].astype(np.float32)
    return np.concatenate([world, attrs], axis=1)


def _rgb_to_hue_sat(rgb):
    '''Vectorized hue [0, 1) + saturation (matplotlib.colors.rgb_to_hsv
    semantics, without the per-call masked-array overhead).'''
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = rgb.max(axis=-1)
    delta = mx - rgb.min(axis=-1)
    safe = np.where(delta > 0.0, delta, 1.0)
    h = np.where(mx == r, (g - b) / safe,
                 np.where(mx == g, 2.0 + (b - r) / safe,
                          4.0 + (r - g) / safe))
    h = np.where(delta > 0.0, (h / 6.0) % 1.0, 0.0)
    s = np.where(mx > 0.0, delta / np.where(mx > 0.0, mx, 1.0), 0.0)
    return h, s


def instance_ids_from_preflat(flat):
    '''Nearest hue-cluster instance ids; background (low saturation) = -1
   .'''
    hue, sat = _rgb_to_hue_sat(flat)
    hue = np.round(hue * 360.0)[..., None]
    ids = np.abs(hue[..., None] - np.asarray(PREFLAT_HUE_CLUSTERS)).argmin(-1)
    ids = ids.astype(np.float32)
    ids[sat[..., None] < 0.9] = -1.0
    return ids  # (H, W, 1).


def greater_frame_points(rgb, flat, depth, cam_RT, cam_K, cuboid):
    '''
    Fused per-frame decode: preflat hue clustering + unprojection + cuboid &
    curving-floor filtering (the __getitem__ hot path,
    Runs in one C++ pixel pass when the native library is available
    (native/frame_ops.cpp); the numpy fallback below is the semantics oracle
    and is bit-identical (tests/test_torch_data.py).
    :return (pcl (N, 7) f32 rows (x, y, z, inst, R, G, B), n_valid) where
        n_valid counts depth-valid pixels before filtering.
    '''
    from .. import native

    inv_K, inv_RT = _inverse_cams(cam_RT, cam_K)
    res = native.greater_frame_host(rgb, flat, depth, inv_K, inv_RT,
                                    tuple(cuboid))
    if res is not None:
        return res

    inst = instance_ids_from_preflat(flat)
    valid_y, valid_x = np.where(depth > 0.0)
    z = depth[valid_y, valid_x].astype(np.float32)
    world = _unproject(valid_x, valid_y, z, inv_K, inv_RT)
    attrs = np.concatenate([inst, rgb], axis=-1)[valid_y, valid_x] \
        .astype(np.float32)
    pcl = np.concatenate([world, attrs], axis=1)
    keep = np.asarray(cuboid_mask(pcl, cuboid)) & np.asarray(greater_floor_mask(pcl))
    return pcl[keep], pcl.shape[0]


def greater_frame_points_png(rgb_fp, flat_fp, depth_fp, cam_RT, cam_K, cuboid):
    '''
    greater_frame_points, but fused all the way down to the PNG byte streams
    (native/png_ops.cpp): decode + u8->f32 conversion + hue clustering +
    unprojection + filtering in ONE native call, without the full-image
    float arrays. Bit-identical to the _imread + greater_frame_points chain
    (tests/test_torch_data.py). Returns None when the native path can't serve
    these files (library or its zlib decode unavailable, palette / interlaced
    PNG, ...) - callers fall back to the decode chain above.
    '''
    from .. import native
    inv_K, inv_RT = _inverse_cams(cam_RT, cam_K)
    return native.greater_frame_host_png(rgb_fp, flat_fp, depth_fp, inv_K,
                                         inv_RT, tuple(cuboid),
                                         MAX_DEPTH_CLIP)


class GreaterDataset:
    '''Map-style dataset: __getitem__(index) -> dict of numpy arrays.'''

    def __init__(self, dataset_root, logger, stage='train',
                 ss_frame_step=2, video_length=4, frame_skip=4, convert_to_pcl=True,
                 n_points_rnd=8192, n_fps_input=1024, n_fps_target=1024,
                 pcl_input_frames=3, pcl_target_frames=1,
                 sample_bias='none', sb_occl_frame_shift=2,
                 min_z=-1.0, other_bounds=5.0, return_segm=True, track_mode='none',
                 use_data_frac=1.0, use_json=True, verbose=False,
                 live_occl_mode='normal', force_view_idx=-1, seed=None,
                 return_images=False, shared_counters=False):
        self.dataset_root = dataset_root
        self.logger = logger
        self.stage = stage
        self.ss_frame_step = ss_frame_step
        self.video_length = video_length
        self.frame_skip = frame_skip
        self.n_points_rnd = n_points_rnd
        self.n_fps_input = n_fps_input
        self.n_fps_target = n_fps_target
        self.pcl_input_frames = pcl_input_frames
        self.pcl_target_frames = pcl_target_frames
        self.sample_bias = sample_bias
        self.sb_occl_frame_shift = sb_occl_frame_shift
        self.min_z = min_z
        self.other_bounds = other_bounds
        self.return_segm = return_segm
        self.track_mode = track_mode
        self.use_data_frac = use_data_frac
        self.use_json = use_json
        self.verbose = verbose
        self.live_occl_mode = live_occl_mode
        self.force_view_idx = force_view_idx
        self.return_images = return_images
        self.allow_random_frames = True
        self.seed = seed
        self._epoch = 0

        self.stage_dir = os.path.join(dataset_root, stage)
        if not os.path.exists(self.stage_dir):
            self.stage_dir = dataset_root
            self.dataset_root = str(pathlib.Path(dataset_root).parent)
        self.is_single_scene = 'images_view1' in os.listdir(self.stage_dir)

        if self.is_single_scene:
            logger.warning(f'({stage}) Pointing to a single scene; ignoring '
                           f'sample_bias / use_json.')
            self.num_scenes = 1
            self.all_scenes = [self.stage_dir]
            num_frames = len(self._rgb_frames(self.stage_dir))
            if use_data_frac < 0.0:
                self.use_data_frac, self.multiplier = 1.0, use_data_frac
            else:
                self.multiplier = (num_frames / self.ss_frame_step
                                   - self.video_length * self.frame_skip)
            self.dset_size = int(self.multiplier * self.use_data_frac)
        else:
            scenes = sorted(dn for dn in os.listdir(self.stage_dir) if '_' in dn
                            and os.path.isdir(os.path.join(self.stage_dir, dn)))
            self.all_scenes = scenes
            self.num_scenes = len(scenes)
            if use_data_frac < 0.0:
                self.num_scenes = min(int(-use_data_frac), len(self.all_scenes))
                self.all_scenes = self.all_scenes[:self.num_scenes]
                self.use_data_frac = 1.0
                self.allow_random_frames = False
            # Virtual-epoch multiplier: ~960 train / 120 val examples
            #.
            target_size = 960 if 'train' in stage else 120
            self.multiplier = max(int(np.ceil(target_size / max(self.num_scenes, 1))), 1)
            self.dset_size = int(self.num_scenes * self.multiplier * self.use_data_frac)

            self.counter = (common.CounterBoard(self.num_scenes, shared=shared_counters)
                            if self.sample_bias != 'none' else None)
            self.starting_frames = None
            if 'test' in stage and use_json:
                fn = (f'test_start_frames_shift{sb_occl_frame_shift}'
                      f'_inputframes12_skip{frame_skip}.json')
                self.json_shift = (12 - pcl_input_frames) * frame_skip
                fp = os.path.join(self.dataset_root, fn)
                if os.path.exists(fp):
                    with open(fp, 'r') as f:
                        self.starting_frames = json.load(f)
                else:
                    logger.warning(f'({stage}) {fp} not found.')

    @staticmethod
    def _rgb_frames(scene_dp):
        image_dp = os.path.join(scene_dp, 'images_view1')
        return [fn for fn in os.listdir(image_dp)
                if fn[-4:] == '.png' and len(fn) <= 8]

    def __len__(self):
        return self.dset_size

    def set_epoch(self, epoch):
        '''Advance the per-example RNG stream (called by Loader.epoch).'''
        self._epoch = int(epoch)

    def _example_rng(self, index):
        return common.example_rng(self.seed, self._epoch, index)

    def _get_frame_start(self, index, scene_dp, src_view, rng):
        num_frames = len(self._rgb_frames(scene_dp))
        occl_frame_idx, found_occl_rate = -1, -1.0
        if self.is_single_scene:
            return index * self.ss_frame_step, src_view, num_frames, -1, -1.0

        scene_idx = index // self.multiplier
        frame_start_high = max(num_frames - self.video_length * self.frame_skip, 1)
        frame_start = rng.randint(0, frame_start_high)

        if self.starting_frames is not None:
            frame_start, src_view = self.starting_frames[str(scene_idx)]
            frame_start += self.json_shift
        elif 'test' not in self.stage and rng.rand() >= 0.30:
            pass  # biased clip sampling only 30% of the time.
        elif self.sample_bias != 'none':
            if 'occl' in self.sample_bias:
                rate = get_occlusion_rate(scene_dp, src_view)
                time_shift = int((self.pcl_input_frames - self.sb_occl_frame_shift)
                                 * self.frame_skip)
                start, occl_frame_idx, found_occl_rate = common.pick_biased_frame_start(
                    rate, 0, frame_start_high, time_shift, 40, self.counter,
                    scene_idx, self.stage, rng)
                if start is not None:
                    frame_start = start
        elif not self.allow_random_frames:
            frame_start = min(num_frames // 2, frame_start_high - 1)
        return frame_start, src_view, num_frames, occl_frame_idx, found_occl_rate

    def __getitem__(self, index):
        rng = self._example_rng(index)
        if self.is_single_scene:
            scene_idx, scene_dp = -1, self.all_scenes[0]
        else:
            scene_idx = index // self.multiplier
            scene_dp = os.path.join(self.stage_dir, self.all_scenes[scene_idx])

        image_dps = sorted(os.path.join(scene_dp, dn) for dn in os.listdir(scene_dp)
                           if 'images' in dn)
        pose_dps = sorted(os.path.join(scene_dp, dn) for dn in os.listdir(scene_dp)
                          if 'poses' in dn)
        num_views = len(image_dps)
        src_view = (self.force_view_idx if self.force_view_idx >= 0
                    else rng.randint(num_views))

        (frame_start, src_view, num_frames, occl_frame_idx, found_occl_rate) = \
            self._get_frame_start(index, scene_dp, src_view, rng)
        frame_inds = np.arange(frame_start,
                               frame_start + self.video_length * self.frame_skip,
                               self.frame_skip)

        cub = greater_bounds(self.other_bounds, self.min_z)
        all_pcl, all_rgb, all_depth, all_RT, all_K = [], [], [], [], []
        all_flat, all_snitch = [], []
        # Dataset health signals.
        cuboid_filter_ratios, sample_input_ratios = [], []
        for v in range(num_views):
            src_RT = np.load(os.path.join(pose_dps[v], 'camera_RT.npy'))
            src_K = np.load(os.path.join(pose_dps[v], 'camera_K.npy'))
            view_pcl, view_rgb, view_depth, view_RT, view_K = [], [], [], [], []
            view_flat, view_snitch = [], []
            for f in frame_inds:
                cam_RT = src_RT[f].astype(np.float32)
                cam_K = src_K[f].astype(np.float32)
                cam_K[1, 1] = cam_K[0, 0]  # the dataset's focal fix.

                # (N, 7): (x, y, z, instance_id, R, G, B) — fused one-pass
                # decode. Fastest path decodes the PNGs inside the native op;
                # the data/png.py + numpy chain below is the bit-identical fallback
                # (and the only path that materializes full images, which
                # return_images needs).
                res = None
                if not self.return_images:
                    res = greater_frame_points_png(
                        os.path.join(image_dps[v], f'{f:04d}.png'),
                        os.path.join(image_dps[v], f'{f:04d}_preflat.png'),
                        os.path.join(image_dps[v], f'{f:04d}_depth.png'),
                        cam_RT, cam_K, cub)
                if res is not None:
                    pcl, pre_filter = res
                else:
                    rgb = _imread(os.path.join(
                        image_dps[v], f'{f:04d}.png'))[..., :3] \
                        .astype(np.float32)
                    flat = _imread(os.path.join(
                        image_dps[v], f'{f:04d}_preflat.png'))[..., :3] \
                        .astype(np.float32)
                    depth = _imread(os.path.join(
                        image_dps[v], f'{f:04d}_depth.png')) \
                        .astype(np.float32) * MAX_DEPTH_CLIP
                    if depth.ndim == 3:
                        depth = depth[..., 0]
                    pcl, pre_filter = greater_frame_points(rgb, flat, depth,
                                                           cam_RT, cam_K, cub)
                cuboid_filter_ratios.append(pcl.shape[0] / max(pre_filter, 1))
                pre_sample = pcl.shape[0]
                if self.n_points_rnd > 0 and pcl.shape[0] > self.n_points_rnd:
                    inds = rng.choice(pcl.shape[0], self.n_points_rnd, replace=False)
                    inds.sort()
                    pcl = pcl[inds]
                sample_input_ratios.append(pcl.shape[0] / max(pre_sample, 1))
                view_pcl.append(pcl.astype(np.float32))
                if self.return_images:
                    view_rgb.append(rgb)
                    view_depth.append(depth)
                    view_flat.append(flat)
                    # Snitch mask: the tracked-object segmentation overlay
                    #; zeros when the file is absent.
                    snitch_fp = os.path.join(image_dps[v],
                                             f'{f:04d}_preflat_snitch.png')
                    if os.path.exists(snitch_fp):
                        snitch = _imread(snitch_fp)[..., :3].astype(np.float32)
                    else:
                        snitch = np.zeros_like(flat)
                    view_snitch.append(snitch)
                view_RT.append(cam_RT)
                view_K.append(cam_K)
            all_pcl.append(view_pcl)
            all_RT.append(np.stack(view_RT))
            all_K.append(np.stack(view_K))
            if self.return_images:
                all_rgb.append(np.stack(view_rgb))
                all_depth.append(np.stack(view_depth))
                all_flat.append(np.stack(view_flat))
                all_snitch.append(np.stack(view_snitch))

        # Only the source view's time-accumulated video is ever consumed
        #: skip building the other views'.
        pcl_video_src = accumulate_pcl_time([all_pcl[src_view]])[0]
        # (T*N, 8): (x, y, z, inst, R, G, B, t).
        # Full multi-view merged rows are consumed only by the target frames;
        # valo counting needs just the instance column of every frame.
        n_tf = self.pcl_target_frames
        merged_targets = merge_pcl_views([view[-n_tf:] for view in all_pcl],
                                         insert_view_idx=True)
        # list-n_tf of (V*N, 8): (x, y, z, inst, view, R, G, B).
        merged_inst = [np.concatenate([all_pcl[v][t][:, 3:4]
                                       for v in range(num_views)])
                       for t in range(self.video_length)]

        # Input: source view, first pcl_input_frames frames.
        if self.pcl_input_frames < self.video_length:
            keep = sum(all_pcl[src_view][t].shape[0]
                       for t in range(self.pcl_input_frames))
            pcl_input = pcl_video_src[:keep]
        else:
            pcl_input = pcl_video_src
        pcl_input = common.shuffle_rows(pcl_input, rng)
        pcl_input, pcl_input_size = common.subsample_pad(
            pcl_input, self.n_fps_input, mode='farthest_point', rng=rng,
            fps_start=rng.randint(max(pcl_input.shape[0], 1)))

        # Targets: merged multi-view frames, random-subsampled (n_fps_target < 0).
        tgt_cap = abs(self.n_fps_target) if self.n_fps_target != 0 else \
            max(f.shape[0] for f in merged_inst)
        pcl_target, pcl_target_size = [], []
        for t in range(self.pcl_target_frames):
            frame = merged_targets[t]
            if self.n_fps_target != 0:
                mode = 'farthest_point' if self.n_fps_target > 0 else 'random'
                # shuffle=True == shuffle_rows + subsample (same rng stream),
                # composed so only the kept rows are gathered.
                frame, size = common.subsample_pad(frame, tgt_cap, mode=mode,
                                                   rng=rng, shuffle=True)
            else:
                frame = common.shuffle_rows(frame, rng)
                frame, size = common.pad_rows(frame, tgt_cap)
            pcl_target.append(frame)
            pcl_target_size.append(size)

        # Split semantic (instance) column out of the input.
        pcl_input_sem = pcl_input[:, 3:-4]                           # (N, 1).
        pcl_input = np.concatenate([pcl_input[:, :3], pcl_input[:, -4:]], axis=-1)
        # (N, 7): (x, y, z, R, G, B, t).

        live_occl, valo_pad, num_valo = common.get_valo_ids(
            pcl_input_sem, merged_inst, all_pcl, src_view, num_views,
            self.pcl_input_frames, self.video_length, filter_vehped=False,
            sem_inst_col=0, sem_cat_col=0, merged_inst_col=0, pcl_inst_col=3,
            max_valo_ids=MAX_VALO_IDS)

        # Track marking: mark one instance in the first
        # input frame and in all target frames.
        track_id = -1
        input_track = np.zeros_like(pcl_input[:, 0:1])
        target_track = [np.zeros_like(f[:, 0:1]) for f in pcl_target]
        if self.track_mode != 'none':
            first_sem = pcl_input_sem[pcl_input[:, -1] == 0]
            vis_ids = [int(i) for i in np.unique(first_sem[:, 0].astype(np.int32))
                       if i >= 0 and (first_sem[:, 0] == i).sum() >= 16]
            if vis_ids:
                track_id = 0 if self.track_mode == 'snitch' else int(rng.choice(vis_ids))
                mark = (pcl_input_sem[:, 0] == track_id) & (pcl_input[:, -1] == 0)
                input_track[mark] = 1.0
                for i in range(self.pcl_target_frames):
                    target_track[i][pcl_target[i][:, 3] == track_id] = 1.0

        pcl_input = np.concatenate([pcl_input, input_track], axis=-1)  # (N, 8).
        pcl_target = [np.concatenate([f, tt], axis=-1)
                      for f, tt in zip(pcl_target, target_track)]      # (M, 9).

        valid = np.zeros((self.pcl_target_frames, tgt_cap), bool)
        for t, size in enumerate(pcl_target_size):
            valid[t, :size] = True

        out = dict(
            pcl_input=pcl_input.astype(np.float32),
            pcl_input_sem=pcl_input_sem.astype(np.float32),
            pcl_target=np.stack(pcl_target).astype(np.float32),      # (T, M, 9).
            pcl_target_valid=valid,
            valo_ids=valo_pad,
            num_valo_ids=np.int32(num_valo),
            cam_RT=np.stack(all_RT), cam_K=np.stack(all_K),
            meta_data=dict(
                data_kind=1001, num_views=num_views, num_frames=num_frames,
                scene_idx=scene_idx, frame_inds=frame_inds, src_view=src_view,
                n_fps_input=self.n_fps_input, n_fps_target=self.n_fps_target,
                pcl_input_size=pcl_input_size, pcl_target_size=pcl_target_size,
                occl_frame_idx=occl_frame_idx, found_occl_rate=found_occl_rate,
                valo_ids=valo_pad, num_valo_ids=num_valo, live_occl=live_occl,
                track_id=track_id,
                cuboid_filter_ratios=np.asarray(cuboid_filter_ratios, np.float32),
                sample_input_ratios=np.asarray(sample_input_ratios, np.float32)),
        )
        if self.return_images:
            # (V, T, H, W, 3) / (V, T, H, W) stacks.
            out['rgb'] = np.stack(all_rgb)
            out['depth'] = np.stack(all_depth)
            out['flat'] = np.stack(all_flat)
            out['snitch'] = np.stack(all_snitch)
        return out
