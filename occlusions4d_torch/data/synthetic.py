'''
Synthetic tiny-scene generators emitting the exact on-disk formats of the GREATER and
CARLA-4D datasets, for tests and end-to-end driver runs without the real data
(own copy of occlusions4d_tpu/data/synthetic.py: the same seeds give the same
.npy bytes and the same PNG pixels; the PNGs are written by data/png.py, so
no imaging package is needed).

GREATER scenes render a handful of colored spheres orbiting above a plane from
multiple pinhole views (RGB + depth + preflat instance hues + snitch mask + poses +
occl.txt). CARLA scenes emit semantic-lidar point sets around a moving ego with
sensor matrices and occlusion-rate curves.
'''

import os

import zlib

import numpy as np

from .greater import PREFLAT_HUE_CLUSTERS, MAX_DEPTH_CLIP
from .png import to_u8, write_png

__all__ = ['make_greater_scene', 'make_greater_dataset', 'make_carla_scene',
           'make_carla_dataset']


def _write_png(fp, arr):
    '''arr float [0,1] (H, W) or (H, W, 3) -> 8-bit png.'''
    write_png(fp, to_u8(arr))


def _hsv_to_rgb(hsv):
    '''One (3,) float32 HSV colour -> float32 RGB, with the arithmetic of
    matplotlib.colors.hsv_to_rgb (h * 6 and p in float32, the terms of f in
    float64 as numpy promotes them there, stored as float32): the preflat
    hues' exact pixel values.'''
    h, s, v = (np.float32(c) for c in hsv)
    h6 = h * np.float32(6.0)
    i = int(h6)
    f = np.float64(h6) - i
    p = v * (np.float32(1.0) - s)
    q = np.float64(v) * (1.0 - np.float64(s) * f)
    t = np.float64(v) * (1.0 - np.float64(s) * (1.0 - f))
    if s == 0:
        return np.array([v, v, v], np.float32)
    return np.array([(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
                     (v, p, q)][i % 6], np.float32)


def _look_at_rt(eye, target=(0.0, 0.0, 1.0)):
    '''World->camera extrinsics [R|t] for a camera at `eye` looking at `target`,
    OpenCV convention (x right, y down, z forward).'''
    eye = np.asarray(eye, np.float32)
    fwd = np.asarray(target, np.float32) - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0], np.float32)
    right = np.cross(fwd, up)
    right = right / max(np.linalg.norm(right), 1e-8)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])                     # rows: camera axes.
    t = -R @ eye
    return np.concatenate([R, t[:, None]], axis=1).astype(np.float32)  # (3, 4).


def _sphere_centers(num_objects, num_frames, rng):
    '''Orbiting object trajectories within the GREATER cube.'''
    phases = rng.rand(num_objects) * 2 * np.pi
    radii = 1.0 + rng.rand(num_objects) * 2.0
    speeds = (rng.rand(num_objects) - 0.5) * 0.2
    heights = 0.4 + rng.rand(num_objects) * 1.2
    out = np.zeros((num_frames, num_objects, 3), np.float32)
    for f in range(num_frames):
        ang = phases + speeds * f
        out[f, :, 0] = radii * np.cos(ang)
        out[f, :, 1] = radii * np.sin(ang)
        out[f, :, 2] = heights
    return out


def make_greater_scene(scene_dp, num_views=3, num_frames=24, image_size=40,
                       num_objects=3, seed=0):
    '''Write one GREATER-format scene directory.'''
    rng = np.random.RandomState(seed)
    os.makedirs(scene_dp, exist_ok=True)
    H = W = image_size
    f_px = image_size * 0.9
    K = np.array([[f_px, 0, W / 2], [0, f_px, H / 2], [0, 0, 1]], np.float32)
    centers = _sphere_centers(num_objects, num_frames, rng)
    radius = 0.9
    colors = rng.rand(num_objects, 3) * 0.7 + 0.3
    hues = np.asarray(PREFLAT_HUE_CLUSTERS[:num_objects], np.float32)
    floor_half = 4.0  # inside the |xy| < 4.5 region the floor fix keeps.

    cam_eyes = [(6.0 * np.cos(a), 6.0 * np.sin(a), 3.0)
                for a in np.linspace(0, 2 * np.pi, num_views, endpoint=False)]
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')

    for v, eye in enumerate(cam_eyes):
        img_dp = os.path.join(scene_dp, f'images_view{v + 1}')
        pose_dp = os.path.join(scene_dp, f'poses_view{v + 1}')
        os.makedirs(img_dp, exist_ok=True)
        os.makedirs(pose_dp, exist_ok=True)
        RT = _look_at_rt(eye)                            # static camera per view.
        np.save(os.path.join(pose_dp, 'camera_RT.npy'),
                np.tile(RT[None], (num_frames, 1, 1)))
        np.save(os.path.join(pose_dp, 'camera_K.npy'),
                np.tile(K[None], (num_frames, 1, 1)))

        inv_K = np.linalg.inv(K)
        rays = inv_K @ np.stack([xs.ravel() + 0.0, ys.ravel() + 0.0,
                                 np.ones(H * W)], axis=0)  # camera-space dirs, z=1.

        for f in range(num_frames):
            # Ray-trace spheres (camera space) for depth + instance + color.
            depth = np.zeros(H * W, np.float32)
            inst = -np.ones(H * W, np.int32)
            R, t = RT[:, :3], RT[:, 3]
            best_z = np.full(H * W, np.inf, np.float32)
            for o in range(num_objects):
                c_cam = R @ centers[f, o] + t
                # Solve |d*z_dir - c| = r along normalized-by-z ray: points p = z * rays.
                a = np.sum(rays ** 2, axis=0)
                b = -2 * np.sum(rays * c_cam[:, None], axis=0)
                cc = np.sum(c_cam ** 2) - radius ** 2
                disc = b ** 2 - 4 * a * cc
                hit = disc > 0
                z = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), np.inf)
                closer = hit & (z > 0.05) & (z < best_z)
                best_z = np.where(closer, z, best_z)
                inst = np.where(closer, o, inst)
            # Ground plane at world z = 0, |x|,|y| <= floor_half (inside the region
            # the GREATER floor fix keeps). Instance id stays -1 (background).
            Rt_t = R.T @ t
            dir_wz = (R.T @ rays)[2]                      # world-z of ray direction.
            z_floor = np.where(np.abs(dir_wz) > 1e-6, Rt_t[2] / dir_wz, np.inf)
            # Parallel rays carry z_floor = inf; 0 * inf inside the matmul
            # would emit NaN warnings (the pixels are masked out below either
            # way), so intersect those rays at a finite dummy depth instead.
            z_fin = np.where(np.isfinite(z_floor), z_floor, 0.0)
            w_pts = R.T @ (rays * z_fin[None]) - Rt_t[:, None]
            on_floor = ((z_floor > 0.05) & (z_floor < best_z)
                        & (np.abs(w_pts[0]) <= floor_half)
                        & (np.abs(w_pts[1]) <= floor_half))
            best_z = np.where(on_floor, z_floor, best_z)
            inst = np.where(on_floor, -1, inst)

            hit_any = np.isfinite(best_z)
            depth = np.where(hit_any, best_z, 0.0)

            rgb = np.zeros((H * W, 3), np.float32)
            rgb[on_floor] = 0.45                          # gray floor.
            flat = np.zeros((H * W, 3), np.float32)
            flat[on_floor] = 0.45                         # low saturation -> id -1.
            snitch = np.zeros((H * W, 3), np.float32)
            for o in range(num_objects):
                sel = inst == o
                rgb[sel] = colors[o]
                flat[sel] = _hsv_to_rgb(
                    np.array([hues[o] / 360.0, 1.0, 1.0], np.float32))
                if o == 0:
                    snitch[sel] = 1.0

            _write_png(os.path.join(img_dp, f'{f:04d}.png'), rgb.reshape(H, W, 3))
            _write_png(os.path.join(img_dp, f'{f:04d}_preflat.png'),
                       flat.reshape(H, W, 3))
            _write_png(os.path.join(img_dp, f'{f:04d}_preflat_snitch.png'),
                       snitch.reshape(H, W, 3))
            _write_png(os.path.join(img_dp, f'{f:04d}_depth.png'),
                       (depth / MAX_DEPTH_CLIP).reshape(H, W))

    # Per-view snitch occlusion curves: a (V, T) table.
    occl = rng.rand(num_views, num_frames) * 0.5
    np.savetxt(os.path.join(scene_dp, 'occl.txt'), occl)


def make_greater_dataset(root, num_scenes=2, stages=('train', 'val', 'test'), **kw):
    for stage in stages:
        for s in range(num_scenes):
            make_greater_scene(os.path.join(root, stage, f'GREATER_{s:06d}'),
                               seed=s + (zlib.crc32(stage.encode()) % 1000), **kw)
    return root


def make_carla_scene(scene_dp, num_frames=60, points_per_frame=3000, seed=0,
                     cube_mode=4):
    '''Write one CARLA-format scene directory.'''
    rng = np.random.RandomState(seed)
    scene_dn = os.path.basename(scene_dp.rstrip('/'))
    content_dp = os.path.join(scene_dp, 'mv_raw_all')
    os.makedirs(content_dp, exist_ok=True)

    num_sensors = 9
    T = num_frames
    sensor_RT = np.tile(np.eye(4, dtype=np.float32)[None, None], (T, num_sensors, 1, 1))
    # Ego moves forward along +x; sensors offset per view. Offsets stay small so
    # the scene remains inside the cube_mode input/output cuboids (z in
    # [min_z, 0.5 * bounds], y in [-bounds, bounds]) for every random seed.
    offsets = rng.randn(num_sensors, 3).astype(np.float32) * 0.3
    for t in range(T):
        for s in range(num_sensors):
            sensor_RT[t, s, :3, 3] = np.array([t * 0.5, 0, 0], np.float32) + offsets[s]
    np.save(os.path.join(content_dp, 'sensor_matrices.npy'), sensor_RT)
    K = np.array([[30.0, 0, 20], [0, 30.0, 15], [0, 0, 1]], np.float32)
    np.save(os.path.join(content_dp, 'camera_K.npy'), K)

    # Persistent structured world (so density, color, AND semantics are
    # learnable functions of position - a per-frame random cloud would make
    # everything but occupancy pure noise): a road plane, two walls, a few
    # static box landmarks, plus a vehicle and a pedestrian moving with the
    # ego. sem/inst/color are constant per structure; per-frame clouds sample
    # the surfaces near the ego with small jitter.
    x_hi = 16.0 + 0.5 * T

    def _box(rng, n, center, size):
        p = (rng.rand(n, 3).astype(np.float32) - 0.5) * np.asarray(size, np.float32)
        p += np.asarray(center, np.float32)
        return p

    def _sample_world(rng, n, ego_x):
        '''(n, 9) rows (x, y, z, cos, inst, sem, R, G, B) in world coords.'''
        counts = [int(n * f) for f in (0.40, 0.10, 0.10, 0.20, 0.12, 0.08)]
        # Landmark points split evenly; fold both remainders into the road so
        # every frame has EXACTLY n rows regardless of n.
        per_landmark = max(counts[3] // len(landmarks), 1)
        counts[3] = per_landmark * len(landmarks)
        counts[0] += n - sum(counts)
        parts = []
        # Road: z ~ 0, color a smooth function of position (learnable).
        g = rng.rand(counts[0], 3).astype(np.float32)
        gx = g[:, 0] * 19.0 - 3.0 + ego_x
        gy = g[:, 1] * 12.0 - 6.0
        gz = g[:, 2] * 0.05
        gc = np.stack([0.4 + 0.2 * np.sin(gx * 0.7), np.full_like(gx, 0.4),
                       0.4 + 0.2 * np.cos(gy * 0.7)], axis=1)
        parts.append((np.stack([gx, gy, gz], 1), 1, 0, gc))
        for side, (cnt, inst) in zip((-6.0, 6.0), [(counts[1], 1),
                                                   (counts[2], 2)]):
            w = rng.rand(cnt, 3).astype(np.float32)
            wx = w[:, 0] * 19.0 - 3.0 + ego_x
            wz = w[:, 2] * 1.3
            wy = np.full_like(wx, side) + w[:, 1] * 0.1
            col = np.tile(np.asarray([0.8, 0.3, 0.3] if side < 0
                                     else [0.3, 0.3, 0.8], np.float32),
                          (cnt, 1))
            parts.append((np.stack([wx, wy, wz], 1), 2, inst, col))
        # Static landmark boxes along the road (positions fixed per scene).
        # Semantic tags avoid 4/10, which are RESERVED for the movers (the
        # vehped / ivalo / VALO paths key on those CARLA classes).
        for j, (bc, bcol) in enumerate(landmarks):
            p = _box(rng, per_landmark, bc, (1.2, 1.2, 1.1))
            parts.append((p, (3, 5, 6, 7)[j % 4], 3 + j,
                          np.tile(bcol, (per_landmark, 1))))
        # Movers: vehicle (tag 10) ahead of ego, pedestrian (tag 4) beside.
        p = _box(rng, counts[4], (ego_x + 6.0, 2.0, 0.6), (2.4, 1.2, 1.0))
        parts.append((p, 10, 20, np.tile(np.asarray([0.9, 0.1, 0.1],
                                                    np.float32),
                                         (counts[4], 1))))
        p = _box(rng, counts[5], (ego_x + 3.0, -2.5, 0.5), (0.5, 0.5, 1.0))
        parts.append((p, 4, 21, np.tile(np.asarray([0.1, 0.8, 0.2],
                                                   np.float32),
                                        (counts[5], 1))))
        rows = []
        for p, sem, inst, col in parts:
            r = np.zeros((p.shape[0], 9), np.float32)
            r[:, :3] = p
            r[:, 3] = rng.rand(p.shape[0])               # cosine angle.
            r[:, 4] = inst
            r[:, 5] = sem
            r[:, 6:9] = np.clip(col, 0.0, 1.0)
            rows.append(r)
        return np.concatenate(rows, axis=0)

    landmarks = [((rng.rand() * (x_hi - 2.0), rng.rand() * 8.0 - 4.0, 0.55),
                  rng.rand(3).astype(np.float32) * 0.6 + 0.2)
                 for _ in range(4)]

    views = ['forward', 'magic_left', 'magic_right', 'magic_top']
    view_sensors = [0, 3, 4, 5]
    for f in range(T):
        ego_x = f * 0.5
        for v, view in enumerate(views):
            world = _sample_world(rng, points_per_frame, ego_x)
            # Transform world -> sensor frame (x' = inv(RT) @ x).
            RT = sensor_RT[f, view_sensors[v]]
            n = world.shape[0]
            pts = np.concatenate([world[:, :3].T, np.ones((1, n), np.float32)])
            local = np.linalg.inv(RT) @ pts
            world[:, :3] = local[:3].T
            np.save(os.path.join(content_dp, f'{f:05d}_{view}_lidar_segm.npy'), world)
            _write_png(os.path.join(content_dp, f'{f:05d}_{view}_rgb.png'),
                       rng.rand(30, 40, 3))

    # Occlusion-rate curves (K_cat, V, T, 3).
    occl = rng.rand(3, 4, T, 3).astype(np.float32)
    np.save(os.path.join(scene_dp, f'occlusion_rate_fs3_cm{cube_mode}.npy'), occl)
    # Video existence marker.
    with open(os.path.join(scene_dp, scene_dn + '_video_multiview.mp4'), 'wb') as fh:
        fh.write(b'\x00')


def make_carla_dataset(root, num_scenes=2, stages=('train', 'val', 'test'), **kw):
    for stage in stages:
        for s in range(num_scenes):
            make_carla_scene(os.path.join(root, stage, f'{stage}_{s:05d}'),
                             seed=s + (zlib.crc32(stage.encode()) % 1000), **kw)
    return root
