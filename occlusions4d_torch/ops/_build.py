'''
Build and load the CUDA kernels of occlusions4d_torch/csrc.

Each csrc/<name>.cu is compiled by nvcc into its own shared library with a
plain C interface (no PyTorch headers: a few seconds per file instead of
minutes), for sm_90a:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC [per-source flags] -o <build>/<name>-<hash>.so <src>

All sources compile in parallel (one nvcc process each, started together) on
the first kernel call, or explicitly through build_all(). Libraries land in
occlusions4d_torch/_build/ (listed in .gitignore), named by a hash of the
source and flags, so an edited source rebuilds and an unchanged one is
reused. Force a rebuild by deleting that directory or setting
O4D_TORCH_REBUILD=1. nvcc is found on PATH, else under CUDA_HOME
(default /usr/local/cuda).

Every C entry point returns cudaGetLastError() after its launch; `check`
raises on a non-zero code. Pointers and the stream travel as ctypes.c_void_p.
'''

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..utils import profiling

__all__ = ['SOURCES', 'nvcc_path', 'build_all', 'library', 'check', 'ptr',
           'stream_ptr', 'count_launch', 'span', 'launch_counts', 'reset_launch_counts']

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     'csrc')
_BASE_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
               '-shared', '-Xcompiler', '-fPIC']
# Per-source flags. kNN and FPS select by exact float comparisons, so their
# arithmetic must round like the plain versions (no a*b+c -> fma contraction).
SOURCES = {
    'knn': ['-fmad=false'],
    'fps': ['-fmad=false'],
    'interp': [],
    'attn': [],
    'interp_bwd': [],
    'attn_bwd': [],
    'gather': [],
}

_LIBS = {}
BUILD_LOGS = {}  # nvcc output of the compiles run in this process.


def nvcc_path():
    for cand in (shutil.which('nvcc'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc')):
        if cand and os.path.isfile(cand):
            return cand
    return None


def _build_dir():
    d = os.path.join(os.path.dirname(_CSRC), '_build')
    os.makedirs(d, exist_ok=True)
    return d


def _lib_path(name):
    src = os.path.join(_CSRC, f'{name}.cu')
    h = hashlib.sha256()
    for path in [src] + sorted(
            os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith('.cuh')):
        with open(path, 'rb') as f:
            h.update(f.read())
    h.update(' '.join(_BASE_FLAGS + SOURCES[name]).encode())
    return src, os.path.join(_build_dir(), f'{name}-{h.hexdigest()[:16]}.so')


def build_all(names=None, verbose=False):
    '''Compile the given sources (default: all) that lack an up-to-date
    library, all nvcc processes at once; verbose adds ptxas's register and
    shared-memory report to BUILD_LOGS. :return {name: seconds} of the
    compiles run (empty when everything was cached).'''
    names = list(SOURCES) if names is None else list(names)
    rebuild = os.environ.get('O4D_TORCH_REBUILD') == '1'
    todo = {}
    for n in names:
        src, out = _lib_path(n)
        if rebuild or not os.path.isfile(out):
            todo[n] = (src, out)
    if not todo:
        return {}
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError('nvcc not found on PATH or under CUDA_HOME; the CUDA '
                           'kernels of occlusions4d_torch cannot be built')
    procs = {}
    t0 = time.time()
    for n, (src, out) in todo.items():
        # A temporary of this process's own: processes that build the same
        # library at once (data-parallel ranks on a fresh tree) each write
        # theirs and move it into place whole.
        tmp = f'{out}.{os.getpid()}.{threading.get_ident()}.tmp'
        cmd = [nvcc] + _BASE_FLAGS + SOURCES[n] + (['-Xptxas', '-v'] if verbose else []) \
            + ['-o', tmp, src]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), out, tmp)
    secs, failed = {}, []
    for n, (p, out, tmp) in procs.items():
        log, _ = p.communicate()
        secs[n] = time.time() - t0
        if p.returncode != 0:
            failed.append(f'--- nvcc {n}.cu (rc {p.returncode}) ---\n{log}')
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        BUILD_LOGS[n] = log
        os.replace(tmp, out)
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))
    return secs


def library(name):
    '''The loaded ctypes library of csrc/<name>.cu (building all stale
    sources on the first call).'''
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        _, out = _lib_path(name)
        lib = ctypes.CDLL(out)
        _LIBS[name] = lib
    return lib


def check(code, what):
    if code != 0:
        raise RuntimeError(f'CUDA kernel {what} failed to launch: '
                           f'cudaError {code}')


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device):
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# Launch counters (each kernel module's LAUNCHES dict) are bumped from every
# thread that launches, e.g. the eval driver's post worker (nn1_direct): one
# lock makes each count and each reset whole.
_COUNT_LOCK = threading.Lock()


def count_launch(launches, name):
    '''Add one to a kernel module's launch count, where it launches its kernel.'''
    with _COUNT_LOCK:
        launches[name] += 1


def span(name):
    '''Context of a kernel's launch: the span o4d_<name> of utils/profiling.py
    (while a device trace records, also on the card's timeline around the
    kernels it launched; nothing unless spans record).'''
    return profiling.span('o4d_' + name)


def _counter_modules():
    # By module path: the package re-exports functions named knn/fps_batched.
    import importlib
    return tuple(importlib.import_module(f'{__package__}.{m}')
                 for m in ('knn', 'fps', 'attention', 'self_attention'))


def launch_counts():
    '''{kernel name: launches} summed over the kernel modules' counters.'''
    out = {}
    with _COUNT_LOCK:
        for m in _counter_modules():
            out.update(m.LAUNCHES)
    return out


def reset_launch_counts():
    with _COUNT_LOCK:
        for m in _counter_modules():
            for k in m.LAUNCHES:
                m.LAUNCHES[k] = 0
