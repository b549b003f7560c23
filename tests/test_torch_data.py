'''
The port's host data plane against the JAX package's, on the CPU:
  * synthetic scenes: the port's make_greater_dataset / make_carla_dataset
    write the same files, the same .npy bytes and the same PNG pixels (read
    with the JAX package's PIL reader) as the JAX generators;
  * the standard-library PNG reader (data/png.py) against PIL on RGB, RGBA,
    grey, grey + alpha, 16-bit grey and palette files, every row filter;
  * the test loader: create_test_loader's batches equal the JAX loader's key
    by key, bit for bit, on GREATER and CARLA data;
  * the native host ops (fps_host, nn1_host on both branches, knn_host,
    greater_frame_host[_png]) equal the JAX package's, and the numpy
    fallbacks equal the native ops (the frame decode through data/png.py
    when the fused PNG decode is not built);
  * the port's data plane and eval driver import and generate a scene with
    jax, flax, optax, occlusions4d_tpu, PIL, imageio and matplotlib blocked.
'''

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from occlusions4d_tpu import native as j_native
from occlusions4d_tpu.config import TestConfig as JTestConfig
from occlusions4d_tpu.config import TrainConfig as JTrainConfig
from occlusions4d_tpu.data import greater as j_greater
from occlusions4d_tpu.data import loader as j_loader
from occlusions4d_tpu.data import synthetic as j_synthetic
from occlusions4d_tpu.utils.logvis import Logger as JLogger
from occlusions4d_torch import native as t_native
from occlusions4d_torch.config import TestConfig
from occlusions4d_torch.data import greater as t_greater
from occlusions4d_torch.data import loader as t_loader
from occlusions4d_torch.data import png as t_png
from occlusions4d_torch.data import synthetic as t_synthetic
from occlusions4d_torch.ops.bounds import greater_bounds
from occlusions4d_torch.utils.logvis import Logger

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(root):
    out = []
    for d, _, fns in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in fns]
    return sorted(out)


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
    '''Both kinds written by both packages' generators.'''
    base = tmp_path_factory.mktemp('synthetic')
    out = {}
    for pkg, syn in (('jax', j_synthetic), ('torch', t_synthetic)):
        g, c = str(base / pkg / 'greater'), str(base / pkg / 'data_carla')
        syn.make_greater_dataset(g, num_scenes=1, num_views=2, num_frames=14,
                                 image_size=28, stages=('train', 'test'))
        syn.make_carla_dataset(c, num_scenes=1, num_frames=44, points_per_frame=900,
                               stages=('test',))
        out[pkg] = dict(greater=g, carla=c)
    return out


@pytest.mark.parametrize('kind', ['greater', 'carla'])
def test_synthetic_scenes_match_jax(scenes, kind):
    j_root, t_root = scenes['jax'][kind], scenes['torch'][kind]
    files = _files(j_root)
    assert files == _files(t_root) and len(files) > 40
    n_png = 0
    for rel in files:
        jp, tp = os.path.join(j_root, rel), os.path.join(t_root, rel)
        if rel.endswith('.png'):
            a, b = j_greater._imread(jp), j_greater._imread(tp)
            assert a.dtype == b.dtype and a.shape == b.shape, rel
            np.testing.assert_array_equal(a, b, err_msg=rel)
            n_png += 1
        else:
            with open(jp, 'rb') as f1, open(tp, 'rb') as f2:
                assert f1.read() == f2.read(), rel
    assert n_png > 20


def _write_png_raw(fp, arr, filters, bit16=False):
    '''A PNG with the given row filter per row (cycled), written without the
    module under test: arr (H, W[, C]) uint8, or uint16 with bit16.'''
    a = np.asarray(arr)
    H, W = a.shape[:2]
    C = 1 if a.ndim == 2 else a.shape[2]
    bpp = C * (2 if bit16 else 1)
    raw = np.frombuffer((a.astype('>u2') if bit16 else a.astype(np.uint8)).tobytes(),
                        np.uint8).reshape(H, W * bpp).astype(np.int32)
    out, prev = bytearray(), np.zeros(W * bpp, np.int32)
    for y in range(H):
        cur, f = raw[y], filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - left
        elif f == 2:
            enc = cur - prev
        elif f == 3:
            enc = cur - ((left + prev) >> 1)
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            enc = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        out.append(f)
        out += (enc & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return struct.pack('>I', len(data)) + tag + data + struct.pack(
            '>I', zlib.crc32(tag + data))

    ihdr = struct.pack('>IIBBBBB', W, H, 16 if bit16 else 8,
                       {1: 0, 2: 4, 3: 2, 4: 6}[C], 0, 0, 0)
    with open(fp, 'wb') as fh:
        fh.write(b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', ihdr)
                 + chunk(b'IDAT', zlib.compress(bytes(out))) + chunk(b'IEND', b''))


def _image(rng, H, W, C, bit16=False):
    gx = np.linspace(0, 200, W)[None, :, None]
    gy = np.linspace(0, 200, H)[:, None, None]
    top = 65535 if bit16 else 255
    a = (gx + gy) * (257 if bit16 else 1) + rng.randint(0, top // 8, (H, W, C))
    a = np.clip(a, 0, top).astype(np.uint16 if bit16 else np.uint8)
    return a[..., 0] if C == 1 else a


@pytest.mark.parametrize('filters', [[0], [1], [2], [3], [4], [4, 3, 1, 0, 2]])
@pytest.mark.parametrize('layout', ['rgb', 'rgba', 'grey', 'grey_alpha', 'grey16'])
def test_png_reader_matches_pil(tmp_path, filters, layout):
    from PIL import Image
    rng = np.random.RandomState(len(filters) * 7 + filters[0])
    C = dict(rgb=3, rgba=4, grey=1, grey_alpha=2, grey16=1)[layout]
    arr = _image(rng, 23, 37, C, bit16=layout == 'grey16')
    fp = str(tmp_path / 'x.png')
    _write_png_raw(fp, arr, filters, bit16=layout == 'grey16')
    got = t_png.read_png(fp)
    np.testing.assert_array_equal(got.astype(np.int64), arr.astype(np.int64))
    with Image.open(fp) as im:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      np.asarray(im).astype(np.int64))
    ref = j_greater._imread(fp)
    out = t_png.imread(fp)
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


def test_png_writer_and_pil_files(tmp_path):
    '''write_png's files read back through PIL, and files PIL writes (its own
    filter choice, palettes with and without transparency) read back here as
    PIL and the JAX reader see them.'''
    from PIL import Image
    rng = np.random.RandomState(5)
    for C in (3, 1, 4):
        a = _image(rng, 19, 31, C)
        fp = str(tmp_path / f'w{C}.png')
        t_png.write_png(fp, a)
        with Image.open(fp) as im:
            np.testing.assert_array_equal(np.asarray(im).astype(np.int64),
                                          a.astype(np.int64))
        np.testing.assert_array_equal(t_png.imread(fp), j_greater._imread(fp))
    rgb = _image(rng, 40, 50, 3)
    for name, im in (('pil_rgb', Image.fromarray(rgb)),
                     ('pil_grey', Image.fromarray(rgb[..., 0])),
                     ('pil_pal', Image.fromarray(rgb).convert('P', palette=Image.ADAPTIVE))):
        fp = str(tmp_path / f'{name}.png')
        im.save(fp)
        np.testing.assert_array_equal(t_png.imread(fp), j_greater._imread(fp), err_msg=name)
    pal = Image.fromarray(rgb).convert('P', palette=Image.ADAPTIVE)
    pal.info['transparency'] = bytes([0, 128] + [255] * 10)
    fp = str(tmp_path / 'pil_pal_trns.png')
    pal.save(fp, transparency=pal.info['transparency'])
    np.testing.assert_array_equal(t_png.imread(fp), j_greater._imread(fp))
    interlaced = str(tmp_path / 'interlaced.png')
    with open(fp, 'rb') as f:
        data = bytearray(f.read())
    data[28] = 1                                  # IHDR interlace byte.
    with open(interlaced, 'wb') as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match='unsupported|CRC|PNG'):
        t_png.read_png(interlaced)


def _test_args(data_path, track_mode):
    kw = dict(data_path=data_path, num_workers=2, seed=7, use_json=False,
              use_data_frac=0.025, track_mode=track_mode, ss_frame_step=2)
    return JTestConfig(**kw), TestConfig(**kw)


def _dset_args(kind, n_points, tracking_lw):
    cfg = JTrainConfig(n_points=n_points, n_data_rnd=2 * n_points, video_len=4,
                       frame_skip=2, past_frames=2, pt_cube_bounds=5.0,
                       cr_cube_bounds=16.0 if kind == 'carla' else 5.0,
                       tracking_lw=tracking_lw)
    return j_loader._train_dset_args(cfg, kind, None)


def _assert_batches_equal(jb, tb):
    assert sorted(jb) == sorted(tb)
    for key in jb:
        if key == 'meta_data':
            for jm, tm in zip(jb[key], tb[key]):
                assert sorted(jm) == sorted(tm)
                for k in jm:
                    np.testing.assert_array_equal(np.asarray(jm[k]), np.asarray(tm[k]),
                                                  err_msg=k)
        else:
            assert jb[key].dtype == tb[key].dtype, key
            np.testing.assert_array_equal(jb[key], tb[key], err_msg=key)


@pytest.mark.parametrize('kind,track_mode', [('greater', 'one'), ('carla', 'none')])
def test_test_loader_matches_jax(scenes, kind, track_mode):
    root = scenes['jax'][kind]
    stage_dir = os.path.join(root, 'test')
    jargs, targs = _test_args(stage_dir, track_mode)
    dargs = _dset_args(kind, 256 if kind == 'greater' else 512, 1.0)
    # The port's train-side dataset arguments are the JAX package's.
    from occlusions4d_torch.config import TrainConfig
    tcfg = TrainConfig(n_points=dargs['n_fps_input'], n_data_rnd=dargs['n_points_rnd'],
                       video_len=4, frame_skip=2, past_frames=2, pt_cube_bounds=5.0,
                       cr_cube_bounds=16.0 if kind == 'carla' else 5.0, tracking_lw=1.0)
    assert t_loader._train_dset_args(tcfg, kind, None) == dargs
    jk, jl = j_loader.create_test_loader(jargs, dargs, JLogger(context='j'))
    tk, tl = t_loader.create_test_loader(targs, dargs, Logger(context='t'))
    assert jk == tk == kind and len(jl.dataset) == len(tl.dataset) >= 2
    jbs, tbs = list(jl.epoch(0)), list(tl.epoch(0))
    assert len(jbs) == len(tbs) == len(jl.dataset)
    for jb, tb in zip(jbs, tbs):
        _assert_batches_equal(jb, tb)


def test_native_ops_match_jax():
    assert j_native.native_available() and t_native.native_available()
    assert t_native.status()['png']
    rng = np.random.RandomState(2)
    xyz = rng.rand(20000, 3).astype(np.float32) * 4 - 2
    for n_out, start in ((300, 11), (64, 0)):
        for srt in (True, False):
            np.testing.assert_array_equal(
                t_native.fps_host(xyz[:6000 if n_out == 64 else None], n_out, start, srt),
                j_native.fps_host(xyz[:6000 if n_out == 64 else None], n_out, start, srt))
    # nn1_host: the brute branch (n m < 2^22) and the grid branch.
    for n, m in ((500, 700), (5000, 2000)):
        q = rng.randn(n, 3).astype(np.float32)
        k = rng.randn(m, 3).astype(np.float32)
        for a, b in zip(t_native.nn1_host(q, k), j_native.nn1_host(q, k)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(t_native.knn_host(q[:300], k, 9), j_native.knn_host(q[:300], k, 9)):
            np.testing.assert_array_equal(a, b)
    H, W = 30, 44
    rgb, flat = rng.rand(H, W, 3).astype(np.float32), rng.rand(H, W, 3).astype(np.float32)
    flat[::3] = flat[::3, :, :1]
    depth = rng.rand(H, W).astype(np.float32) * 10
    depth[rng.rand(H, W) < 0.2] = 0
    iK = np.linalg.inv(np.array([[40., 0, W / 2], [0, 40, H / 2], [0, 0, 1]], np.float32))
    iRT = np.array([[1, 0, 0, 0.3], [0, 0.8, -0.6, 1], [0, 0.6, 0.8, -2]], np.float32)
    cub = greater_bounds(5.0, -1.0)
    a = t_native.greater_frame_host(rgb, flat, depth, iK, iRT, tuple(cub))
    b = j_native.greater_frame_host(rgb, flat, depth, iK, iRT, tuple(cub))
    assert a[1] == b[1] and a[0].shape[0] > 100
    np.testing.assert_array_equal(a[0], b[0])


def test_greater_png_frame_matches_jax_and_fallbacks(tmp_path):
    '''The fused PNG decode against the JAX package's, and the port's three
    routes to a frame bit for bit the same: fused PNG decode, data/png.py +
    the native frame pass (when png_ops is not built), data/png.py + the
    numpy chain (no compiler).'''
    rng = np.random.RandomState(23)
    H, W = 40, 56
    cam_K = np.array([[50., 0., W / 2], [0., 50., H / 2], [0., 0., 1.]], np.float32)
    cam_RT = np.array([[1., 0., 0., 0.5], [0., 1., 0., -1.0], [0., 0., 1., 0.25]],
                      np.float32)
    cub = greater_bounds(5.0, -1.0)
    fps = [str(tmp_path / f'{n}.png') for n in ('rgb', 'flat', 'depth', 'depth16')]
    base = _image(rng, H, W, 3)
    _write_png_raw(fps[0], base, [0, 1, 2, 3, 4])
    _write_png_raw(fps[1], base[..., ::-1], [4, 2])
    depth8 = _image(rng, H, W, 1) // 6            # within 5.3 m: inside the cube.
    depth8[rng.rand(H, W) < 0.2] = 0
    _write_png_raw(fps[2], depth8, [3, 1])
    _write_png_raw(fps[3], depth8.astype(np.uint16) * 257 + 3, [2, 4], bit16=True)

    def chain(depth_fp):
        rgb = t_greater._imread(fps[0])[..., :3].astype(np.float32)
        flat = t_greater._imread(fps[1])[..., :3].astype(np.float32)
        depth = t_greater._imread(depth_fp).astype(np.float32) * t_greater.MAX_DEPTH_CLIP
        return t_greater.greater_frame_points(rgb, flat, depth, cam_RT, cam_K, cub)

    for depth_fp in fps[2:]:
        fused = t_greater.greater_frame_points_png(fps[0], fps[1], depth_fp, cam_RT,
                                                   cam_K, cub)
        ref = j_greater.greater_frame_points_png(fps[0], fps[1], depth_fp, cam_RT,
                                                 cam_K, cub)
        assert fused is not None and fused[0].shape[0] > 50
        assert fused[1] == ref[1]
        np.testing.assert_array_equal(fused[0], ref[0])
        native_pass = chain(depth_fp)
        saved = dict(t_native._STATUS), t_native._lib, t_native._tried
        try:
            t_native._STATUS['png'] = False                   # no zlib.
            assert t_greater.greater_frame_points_png(fps[0], fps[1], depth_fp, cam_RT,
                                                      cam_K, cub) is None
            t_native._lib, t_native._tried = None, True       # no compiler.
            numpy_chain = chain(depth_fp)
        finally:
            t_native._STATUS.update(saved[0])
            t_native._lib, t_native._tried = saved[1], saved[2]
        for got in (native_pass, numpy_chain):
            assert got[1] == fused[1]
            np.testing.assert_array_equal(got[0], fused[0])


def test_numpy_fallbacks_match_native():
    rng = np.random.RandomState(4)
    xyz = rng.rand(3000, 3).astype(np.float32)
    q = rng.randn(400, 3).astype(np.float32)
    k = rng.randn(900, 3).astype(np.float32)
    native = (t_native.fps_host(xyz, 200, 5, False), t_native.nn1_host(q, k),
              t_native.knn_host(q, k, 6))
    saved = t_native._lib, t_native._tried
    try:
        t_native._lib, t_native._tried = None, True
        fallback = (t_native.fps_host(xyz, 200, 5, False), t_native.nn1_host(q, k),
                    t_native.knn_host(q, k, 6))
    finally:
        t_native._lib, t_native._tried = saved
    np.testing.assert_array_equal(fallback[0], native[0])
    for (d_f, i_f), (d_n, i_n) in zip(fallback[1:], native[1:]):
        np.testing.assert_array_equal(i_f, i_n)     # no ties among random keys.
        np.testing.assert_allclose(d_f, d_n, rtol=1e-6, atol=0)


def test_greater_dataset_without_fused_png_decode(scenes):
    '''The GREATER test dataset gives the same example through data/png.py +
    the native frame pass as through the fused PNG decode.'''
    stage_dir = os.path.join(scenes['torch']['greater'], 'test')
    dargs = dict(_dset_args('greater', 256, 0.0), n_fps_target=0, use_json=False)
    ds = t_greater.GreaterDataset(stage_dir, Logger(context='t'), stage='test', seed=3,
                                  **dargs)
    ref = ds[1]
    saved = dict(t_native._STATUS)
    try:
        t_native._STATUS['png'] = False
        got = ds[1]
    finally:
        t_native._STATUS.update(saved)
    for key in ('pcl_input', 'pcl_input_sem', 'pcl_target', 'pcl_target_valid'):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_port_data_plane_runs_without_jax_or_imaging_packages(tmp_path):
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'occlusions4d_tpu', 'PIL', 'imageio',\n"
        "          'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import occlusions4d_torch.evaluate, occlusions4d_torch.data\n"
        "from occlusions4d_torch.data import synthetic, png\n"
        f"root = {str(tmp_path)!r}\n"
        "synthetic.make_greater_dataset(root + '/g', num_scenes=1, num_views=2,\n"
        "                               num_frames=6, image_size=12, stages=('test',))\n"
        "synthetic.make_carla_dataset(root + '/carla', num_scenes=1, num_frames=32,\n"
        "                             points_per_frame=200, stages=('test',))\n"
        "img = png.imread(root + '/g/test/GREATER_000000/images_view1/0000.png')\n"
        "assert img.shape == (12, 12, 3) and img.dtype.name == 'float32'\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, '-c', code], cwd=_ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith('ok'), res.stderr
