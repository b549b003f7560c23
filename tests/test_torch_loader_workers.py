'''
The train loaders' fork workers (data/loader.py, worker_mode='process') on
the CPU, at a tiny synthetic GREATER dataset, 2 workers. Every fork happens in
a subprocess of its own with a time limit (this pytest worker has JAX's
runtime live, and a fork after that can deadlock the child), so a hung
fork fails its test instead of stalling the suite:
  * at sample_bias 'none' the process workers' batches, two epochs of train
    and val, equal the thread workers' bit for bit, and the JAX package's
    process workers' (its own subprocess, JAX not initialised before the
    fork);
  * at sample_bias 'occl' the datasets' shared counter board (a
    multiprocessing.Array) holds every worker's claims: after an epoch the
    parent's board counts exactly the clips the examples claimed, none
    twice;
  * python -m occlusions4d_torch.train --worker_mode process --device cpu
    trains an epoch and writes its checkpoint.
(The eval command line's refusal of --worker_mode process is
tests/test_torch_evaluate.py's.)
'''

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_train_driver import _TINY, _argv, data  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TIMEOUT = 240
_KEYS = ('pcl_input', 'pcl_target', 'pcl_target_valid', 'valo_ids', 'num_valo_ids')

# Dumps the first two epochs of a train configuration's train and val
# loaders (sys.argv[1] 'torch' or 'jax', [2] the output .npz, [3] a JSON
# argv) and, for the port, the train dataset's counter board.
_DUMP = '''
import json, sys
import numpy as np
pkg, out, argv = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
if pkg == 'torch':
    for m in ('jax', 'jaxlib', 'flax', 'optax', 'occlusions4d_tpu'):
        sys.modules[m] = None
    from occlusions4d_torch.config import train_args
    from occlusions4d_torch.data.loader import create_train_val_loaders
    from occlusions4d_torch.utils.logvis import StepLogger
else:
    from occlusions4d_tpu.config import train_args
    from occlusions4d_tpu.data.loader import create_train_val_loaders
    from occlusions4d_tpu.utils.logvis import StepLogger
cfg = train_args(argv)
_, train, val, _ = create_train_val_loaders(cfg, StepLogger(context='dump'))
arrays, claims = {}, []
for name, loader in (('train', train), ('val', val)):
    for epoch in (0, 1):
        for i, b in enumerate(loader.epoch(epoch)):
            for k in %(keys)r:
                arrays[f'{name}_{epoch}_{i}_{k}'] = b[k]
            if name == 'train' and epoch == 0:
                claims += [[int(m['scene_idx']), int(m['frame_inds'][0])]
                           for m in b['meta_data'] if m['occl_frame_idx'] >= 0]
board = train.dataset.counter
if board is not None and pkg == 'torch':
    hit = np.argwhere(board.counts > 0)
    arrays['board_hits'] = hit
    arrays['board_counts'] = board.counts[board.counts > 0]
arrays['claims'] = np.asarray(claims, np.int64).reshape(-1, 2)
np.savez(out, **arrays)
train.close(); val.close()
print('dumped', len(arrays))
''' % dict(keys=_KEYS)


def _dump(pkg, out, argv):
    '''One subprocess run of _DUMP. :return the npz's arrays.'''
    try:
        res = subprocess.run([sys.executable, '-c', _DUMP, pkg, out, json.dumps(argv)],
                             cwd=_ROOT, capture_output=True, text=True, timeout=_TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail(f'{pkg} loader workers did not finish within {_TIMEOUT} s')
    assert res.returncode == 0 and 'dumped' in res.stdout, res.stderr[-3000:]
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def _loader_argv(data, **over):
    return _argv(dict(_TINY, num_workers=2, use_data_frac=0.05, **over)) + [
        '--data_path', data['greater'], '--output_path', '']


def test_process_workers_give_the_thread_workers_batches(data, tmp_path):
    argv = _loader_argv(data)
    thread = _dump('torch', str(tmp_path / 'thread.npz'), argv)
    proc = _dump('torch', str(tmp_path / 'proc.npz'),
                 argv + ['--worker_mode', 'process'])
    jproc = _dump('jax', str(tmp_path / 'jproc.npz'), argv + ['--worker_mode', 'process'])
    batches = [k for k in thread if k.endswith('_pcl_input')]
    assert len(batches) >= 4 and any(k.startswith('val_1_') for k in batches)
    assert sorted(thread) == sorted(proc) == sorted(jproc)
    for k in thread:
        np.testing.assert_array_equal(proc[k], thread[k], err_msg=k)
        np.testing.assert_array_equal(jproc[k], thread[k], err_msg=k)


def test_process_workers_share_the_counter_board(data, tmp_path):
    '''sample_bias 'occl': the parent's board (shared with the forked
    workers) counts one claim for every clip an example of the epoch
    claimed, and no clip twice.'''
    got = _dump('torch', str(tmp_path / 'occl.npz'),
                _loader_argv(data, sample_bias='occl') + ['--worker_mode', 'process'])
    claims = got['claims']
    assert len(claims) >= 4
    assert len({tuple(c) for c in claims}) == len(claims)      # no clip claimed twice.
    assert sorted(map(tuple, got['board_hits'])) == sorted(map(tuple, claims))
    assert (got['board_counts'] == 1).all()


def test_train_command_line_with_process_workers(data, tmp_path):
    ck = str(tmp_path / 'ck')
    argv = _argv(dict(_TINY, num_epochs=1, num_workers=2, use_data_frac=0.02)) + [
        '--device', 'cpu', '--data_path', data['greater'], '--name', 'proc',
        '--worker_mode', 'process', '--checkpoint_root', ck,
        '--log_root', str(tmp_path / 'logs')]
    code = ("import sys, runpy\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'occlusions4d_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"sys.argv = ['occlusions4d_torch.train'] + {argv!r}\n"
            "runpy.run_module('occlusions4d_torch.train', run_name='__main__',"
            " alter_sys=True)\n"
            "print('trained')\n")
    try:
        res = subprocess.run([sys.executable, '-c', code], cwd=_ROOT, capture_output=True,
                             text=True, timeout=_TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail(f'the train command line did not finish within {_TIMEOUT} s')
    assert res.returncode == 0 and 'trained' in res.stdout, res.stderr[-3000:]
    (run,) = os.listdir(ck)
    assert sorted(os.listdir(os.path.join(ck, run))) == ['checkpoint.pkl', 'model_0.pkl']

