'''
Native (C++) host-plane ops with ctypes bindings and lazy compilation (own
copy of occlusions4d_tpu/native/__init__.py; the sources beside this file are
copies of that package's).

The library is built once per source set and host CPU with g++ into
occlusions4d_torch/_build/ (never next to the sources), named by a hash of the
sources, the flags and the CPU, so an edited source or another machine's CPU
rebuilds. frame_ops.cpp and png_ops.cpp compile with -ffp-contract=off (their
bit parity with the numpy chain needs it); host_ops.cpp without.

png_ops.cpp needs zlib's headers. Where they are missing the library is built
without it: greater_frame_host_png then returns None and the loader decodes
the PNGs with data/png.py, whose pixels go through greater_frame_host, bit for
bit the same frame. Without a compiler at all every op takes its numpy
fallback. status() says which of these ran; nothing falls back silently
beyond that record.
'''

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

__all__ = ['fps_host', 'nn1_host', 'knn_host', 'greater_frame_host',
           'greater_frame_host_png', 'native_available', 'status']

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_HERE), '_build')
_SRCS = ('host_ops.cpp', 'frame_ops.cpp', 'png_ops.cpp')
_BASE = ['g++', '-O3', '-march=native', '-fopenmp-simd']
_lock = threading.Lock()
_lib = None
_tried = False
_STATUS = dict(library=False, png=False, error=None, path=None)


def _flags(src):
    # frame_ops.cpp / png_ops.cpp promise bit-exact parity with the numpy data
    # plane: no fma re-rounding there; the distance kernels keep contraction.
    return _BASE + ([] if src == 'host_ops.cpp' else ['-ffp-contract=off'])


def _cpu_id():
    '''The host CPU's model and flags: -march=native code is only reused on
    a CPU that has the same ones.'''
    try:
        with open('/proc/cpuinfo') as f:
            lines = [ln for ln in f if ln.startswith(('model name', 'flags'))]
        return ''.join(sorted(set(lines)))
    except OSError:
        return platform.processor() or platform.machine()


def _lib_path(srcs):
    h = hashlib.sha256(_cpu_id().encode())
    for s in srcs:
        with open(os.path.join(_HERE, s), 'rb') as f:
            h.update(f.read())
        h.update(' '.join(_flags(s)).encode())
    return os.path.join(_BUILD, f'host_ops-{h.hexdigest()[:16]}.so')


def _compile(srcs, out):
    '''Compile each source to an object, link with -lz when png_ops is in,
    and move the library into place.'''
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.{threading.get_ident()}'
    objs = []
    try:
        for s in srcs:
            obj = f'{tmp}.{s[:-4]}.o'
            subprocess.run(_flags(s) + ['-c', '-fPIC', '-o', obj,
                                        os.path.join(_HERE, s)],
                           check=True, capture_output=True, text=True)
            objs.append(obj)
        link = ['-lz'] if 'png_ops.cpp' in srcs else []
        subprocess.run(['g++', '-shared', '-o', tmp, *objs, *link],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        for p in objs + [tmp]:
            if os.path.exists(p):
                os.remove(p)


def _bind(lib, png):
    f32p = np.ctypeslib.ndpointer(np.float32, flags='C')
    f64p = np.ctypeslib.ndpointer(np.float64, flags='C')
    i32p = np.ctypeslib.ndpointer(np.int32, flags='C')
    i64p = np.ctypeslib.ndpointer(np.int64, flags='C')
    i64 = ctypes.c_int64
    lib.o4d_fps.argtypes = [f32p, i64, i64, i64, i32p, f32p]
    lib.o4d_nn1.argtypes = [f32p, i64, f32p, i64, f32p, i32p]
    lib.o4d_nn1_grid.argtypes = [f32p, i64, f32p, i64, f32p, i32p]
    lib.o4d_knn.argtypes = [f32p, i64, f32p, i64, i64, f32p, i32p]
    lib.o4d_greater_frame.argtypes = [
        f32p, f32p, f32p, i64, i64, f32p, f32p, f32p, ctypes.c_int,
        f64p, i64, ctypes.c_float, f32p, i64p]
    lib.o4d_greater_frame.restype = i64
    if png:
        u8p = np.ctypeslib.ndpointer(np.uint8, flags='C')
        lib.o4d_png_dims.argtypes = [u8p, i64, i64p]
        lib.o4d_png_dims.restype = i64
        lib.o4d_greater_frame_png.argtypes = [
            u8p, i64, u8p, i64, u8p, i64, ctypes.c_float,
            f32p, f32p, f32p, ctypes.c_int,
            f64p, i64, ctypes.c_float, f32p, i64p]
        lib.o4d_greater_frame_png.restype = i64
    return lib


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        errors = []
        # With png_ops (needs zlib) first, else without it.
        for srcs in (_SRCS, _SRCS[:2]):
            out = _lib_path(srcs)
            try:
                if not os.path.isfile(out):
                    _compile(srcs, out)
                _lib = _bind(ctypes.CDLL(out), 'png_ops.cpp' in srcs)
                _STATUS.update(library=True, png='png_ops.cpp' in srcs, path=out)
                break
            except (OSError, subprocess.CalledProcessError) as e:
                msg = getattr(e, 'stderr', None) or str(e)
                errors.append(f'{"+".join(srcs)}: {msg.strip()[-400:]}')
        _STATUS['error'] = '\n'.join(errors) or None
    return _lib


def native_available():
    return _load() is not None


def status():
    '''What the host plane runs: dict(library: the C++ library loaded,
    png: its fused PNG decode built (zlib found), error: the compiler's
    messages of the builds that failed, path: the library).'''
    _load()
    return dict(_STATUS)


def fps_host(xyz, n_out, start_idx=0, sort_result=True):
    '''
    Farthest point sampling on host (dataloader path).
    :param xyz (N, C>=3) float array.
    :return (n_out,) int32 indices (sorted ascending when sort_result).
    '''
    xyz = np.ascontiguousarray(np.asarray(xyz, np.float32)[:, :3])
    n = xyz.shape[0]
    n_out = min(int(n_out), n)
    lib = _load()
    if lib is not None:
        out = np.empty(n_out, np.int32)
        scratch = np.empty(n, np.float32)
        lib.o4d_fps(xyz, n, n_out, int(start_idx), out, scratch)
    else:  # numpy fallback.
        out = np.empty(n_out, np.int32)
        out[0] = start_idx
        min_d = np.full(n, np.inf, np.float32)
        for s in range(1, n_out):
            d = np.sum((xyz - xyz[out[s - 1]]) ** 2, axis=-1)
            np.minimum(min_d, d, out=min_d)
            out[s] = int(np.argmax(min_d))
    return np.sort(out) if sort_result else out


def nn1_host(query, keys):
    '''Exact 1-NN (Euclidean) for test-time labels and metrics.
    :return (dists (N,), idx (N,) int32).

    Large problems route to the grid-accelerated kernel (o4d_nn1_grid),
    bit-identical to the brute-force one (same per-pair float expression,
    lexicographic (d, index) winner - see host_ops.cpp); small ones keep the
    brute path, whose setup-free scan wins below ~4M candidate pairs.'''
    query = np.ascontiguousarray(np.asarray(query, np.float32)[:, :3])
    keys = np.ascontiguousarray(np.asarray(keys, np.float32)[:, :3])
    lib = _load()
    if lib is not None:
        n, m = query.shape[0], keys.shape[0]
        d = np.empty(n, np.float32)
        i = np.empty(n, np.int32)
        if n * m >= 1 << 22 and m >= 64:
            lib.o4d_nn1_grid(query, n, keys, m, d, i)
        else:
            lib.o4d_nn1(query, n, keys, m, d, i)
        return d, i
    diffs = np.linalg.norm(query[:, None] - keys[None], axis=-1)
    i = diffs.argmin(axis=-1).astype(np.int32)
    return diffs[np.arange(len(query)), i], i


def _frame_args(inv_K3, inv_RT34, cuboid, clusters):
    if clusters is None:
        from ..data.greater import PREFLAT_HUE_CLUSTERS
        clusters = PREFLAT_HUE_CLUSTERS
    return (np.ascontiguousarray(inv_K3, np.float32).reshape(9),
            np.ascontiguousarray(inv_RT34, np.float32).reshape(12),
            np.ascontiguousarray(np.asarray(cuboid, np.float32).reshape(6)),
            np.ascontiguousarray(np.asarray(clusters, np.float64)))


def greater_frame_host(rgb, flat, depth, inv_K3, inv_RT34, cuboid,
                       use_floor=True, clusters=None, sat_thresh=0.9):
    '''
    Fused GREATER frame decode (frame_ops.cpp): preflat hue clustering +
    unprojection + cuboid/floor filtering in one pixel pass. Bit-identical to
    the numpy chain in data/greater.py.
    :param rgb, flat (H, W, 3) float32; depth (H, W) float32 (metric).
    :param inv_K3 (3, 3), inv_RT34 (3, 4) float32: inverse camera matrices.
    :param cuboid: ops.bounds.Cuboid (or 6 floats x0,x1,y0,y1,z0,z1).
    :param clusters: hue cluster centers (defaults to PREFLAT_HUE_CLUSTERS).
    :return (pcl (N, 7) float32 rows (x, y, z, inst, R, G, B), n_valid) or
        None when the native library is unavailable.
    '''
    lib = _load()
    if lib is None:
        return None
    iK, iRT, cub, cl = _frame_args(inv_K3, inv_RT34, cuboid, clusters)
    rgb = np.ascontiguousarray(rgb, np.float32)
    flat = np.ascontiguousarray(flat, np.float32)
    depth = np.ascontiguousarray(depth, np.float32)
    (H, W) = depth.shape
    out = np.empty((H * W, 7), np.float32)
    n_valid = np.zeros(1, np.int64)
    n = lib.o4d_greater_frame(rgb.reshape(-1), flat.reshape(-1),
                              depth.reshape(-1), H, W, iK, iRT, cub,
                              int(bool(use_floor)), cl, cl.shape[0],
                              float(sat_thresh), out.reshape(-1), n_valid)
    return out[:n].copy(), int(n_valid[0])


def greater_frame_host_png(rgb_fp, flat_fp, depth_fp, inv_K3, inv_RT34,
                           cuboid, depth_scale, use_floor=True, clusters=None,
                           sat_thresh=0.9):
    '''
    Fully fused GREATER frame decode from PNG files (png_ops.cpp): zlib
    inflate + unfilter of the rgb/preflat/depth PNGs, u8 -> f32/255 LUT
    conversion, and the frame_ops.cpp pixel pass, all in one native call.
    Bit-identical to data/png.py's imread + greater_frame_host.
    :param depth_scale: metric scale applied to the [0,1] depth (MAX_DEPTH_CLIP).
    :return (pcl (N, 7) float32, n_valid) or None - when the library or its
        PNG decode (zlib) is unavailable, a file is unreadable, or a PNG uses
        an unsupported flavor (palette/interlace/<8-bit); callers then decode
        with data/png.py.
    '''
    lib = _load()
    if lib is None or not _STATUS['png']:
        return None
    bufs = []
    for fp in (rgb_fp, flat_fp, depth_fp):
        try:
            b = np.fromfile(fp, np.uint8)
        except OSError:
            return None
        if b.size < 33:
            return None
        bufs.append(b)
    wh = np.zeros(2, np.int64)
    if lib.o4d_png_dims(bufs[0], bufs[0].size, wh) < 0:
        return None
    W, H = int(wh[0]), int(wh[1])
    iK, iRT, cub, cl = _frame_args(inv_K3, inv_RT34, cuboid, clusters)
    out = np.empty((H * W, 7), np.float32)
    n_valid = np.zeros(1, np.int64)
    n = lib.o4d_greater_frame_png(
        bufs[0], bufs[0].size, bufs[1], bufs[1].size, bufs[2], bufs[2].size,
        float(depth_scale), iK, iRT, cub, int(bool(use_floor)), cl,
        cl.shape[0], float(sat_thresh), out.reshape(-1), n_valid)
    if n < 0:
        return None
    return out[:n].copy(), int(n_valid[0])


def knn_host(query, keys, k):
    '''Exact kNN on host. :return (dists (N, k), idx (N, k) int32) ascending.'''
    query = np.ascontiguousarray(np.asarray(query, np.float32)[:, :3])
    keys = np.ascontiguousarray(np.asarray(keys, np.float32)[:, :3])
    k = min(int(k), keys.shape[0])
    lib = _load()
    if lib is not None:
        d = np.empty((query.shape[0], k), np.float32)
        i = np.empty((query.shape[0], k), np.int32)
        lib.o4d_knn(query, query.shape[0], keys, keys.shape[0], k, d, i)
        return d, i
    diffs = np.linalg.norm(query[:, None] - keys[None], axis=-1)
    idx = np.argsort(diffs, axis=-1, kind='stable')[:, :k].astype(np.int32)
    return np.take_along_axis(diffs, idx, axis=-1), idx
