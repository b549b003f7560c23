'''
Reading the JAX package's native checkpoints, and turning its parameter trees
into this package's state_dicts.

Native .pkl checkpoints come in two layouts: the legacy bare pickle
{epoch, state, meta} and the crc32 envelope {format, version, crc32, payload}
whose payload is that pickle. Both pickle the optimizer state too, whose
classes (optax NamedTuples) do not exist where the port runs. The reader
therefore unpickles with a restricted Unpickler: numpy's array machinery and
plain containers load as themselves, every other class becomes an inert
placeholder, and only state['params'], epoch and meta are kept. (Unpickle
only files this project wrote: pickle can run code.)

from_jax_params maps a flax variables tree ({'params', ['batch_stats']}) onto
the reference torch key layout (the same keys as the JAX package's
export_torch_state_dict: kernels transposed to (out, in), norm scale ->
weight, batch statistics -> running_mean/var, decoder 'backbone/' dropped).
'''

import collections
import io
import os
import pickle
import zlib

import numpy as np
import torch

__all__ = ['load_native_checkpoint', 'from_jax_params', 'resolve_resume_path']

_CKPT_FORMAT = 'o4d_ckpt'
_CKPT_VERSION = 1
_SAFE_BUILTINS = {'dict', 'list', 'tuple', 'set', 'frozenset', 'int', 'float',
                  'complex', 'str', 'bytes', 'bytearray', 'bool', 'slice', 'range'}


class _Inert:
    '''Stand-in for a pickled class that is not needed (optimizer state).'''

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        self.args = args

    def __setstate__(self, state):
        self.state = state


class _RestrictedUnpickler(pickle.Unpickler):
    _placeholders = {}

    def find_class(self, module, name):
        root = module.split('.')[0]
        if root == 'numpy' or (module == 'builtins' and name in _SAFE_BUILTINS) \
                or (module == 'collections' and name == 'OrderedDict') \
                or (module == 'copyreg' and name == '_reconstructor'):
            return super().find_class(module, name)
        key = (module, name)
        if key not in self._placeholders:
            self._placeholders[key] = type(name, (_Inert,), {'__module__': module})
        return self._placeholders[key]


def _loads(data):
    return _RestrictedUnpickler(io.BytesIO(data)).load()


def load_native_checkpoint(path, epoch=-1):
    '''
    :param path: a .pkl file, or a checkpoint directory (model_{epoch}.pkl, or
        the rolling checkpoint.pkl when epoch < 0).
    :return dict(epoch, params, meta): params is the {'encoder', 'decoder'}
        tree of flax variables dicts of numpy arrays.
    '''
    if os.path.isdir(path):
        path = os.path.join(path, f'model_{epoch}.pkl' if epoch >= 0
                            else 'checkpoint.pkl')
    with open(path, 'rb') as f:
        data = f.read()
    try:
        obj = _loads(data)
    except (EOFError, pickle.UnpicklingError) as e:
        raise ValueError(f'Corrupt or truncated checkpoint {path}: {e}') from e
    if isinstance(obj, dict) and obj.get('format') == _CKPT_FORMAT:
        if obj['version'] > _CKPT_VERSION:
            raise ValueError(f'Checkpoint {path} has schema version '
                             f'{obj["version"]} > supported {_CKPT_VERSION}')
        if zlib.crc32(obj['payload']) != obj['crc32']:
            raise ValueError(f'Checkpoint {path} failed its integrity check '
                             '(crc32 mismatch - corrupt file)')
        obj = _loads(obj['payload'])
    return dict(epoch=obj['epoch'], params=obj['state']['params'], meta=obj['meta'])


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


# '_<digit>' suffixes that are genuine attribute names, not list indices.
_KEEP_UNDERSCORE = {'fc_0', 'fc_1'}


def _torch_key(path):
    parts = []
    for comp in path:
        if comp not in _KEEP_UNDERSCORE and '_' in comp \
                and comp.rsplit('_', 1)[1].isdigit():
            parts.extend(comp.rsplit('_', 1))
        else:
            parts.append(comp)
    if parts and parts[0] == 'backbone':
        parts = parts[1:]
    return '.'.join(parts)


def _tensor(a):
    # Copy: torch.from_numpy would alias the checkpoint's buffers.
    return torch.tensor(np.array(a, dtype=np.float32, copy=True))


def from_jax_params(variables, net):
    '''
    :param variables: flax variables {'params': ..., ['batch_stats': ...]}
        (numpy or array-like leaves), or a bare params tree.
    :param net: the torch module the state_dict is for (its keys are checked).
    :return collections.OrderedDict state_dict of float32 tensors (copies).
    '''
    if 'params' not in variables:
        variables = {'params': variables}
    out = collections.OrderedDict()
    for path, val in _flatten(variables['params']).items():
        leaf, mod = path[-1], path[:-1]
        arr = np.asarray(val)
        if leaf == 'kernel':
            out[_torch_key(mod) + '.weight'] = _tensor(arr.T)
        elif leaf == 'scale':
            out[_torch_key(mod[:-1]) + '.weight'] = _tensor(arr)  # drop 'norm'.
        elif leaf == 'bias':
            key_mod = mod[:-1] if mod and mod[-1] == 'norm' else mod
            out[_torch_key(key_mod) + '.bias'] = _tensor(arr)
        else:
            raise ValueError(f'Unexpected parameter leaf {path}')
    for path, val in _flatten(variables.get('batch_stats', {})).items():
        leaf = {'mean': 'running_mean', 'var': 'running_var'}[path[-1]]
        out[_torch_key(path[:-2]) + '.' + leaf] = _tensor(np.asarray(val))
    expected = set(net.state_dict().keys())
    if set(out) != expected:
        raise KeyError(f'parameter tree does not fit {type(net).__name__}: '
                       f'missing {sorted(expected - set(out))}, '
                       f'unexpected {sorted(set(out) - expected)}')
    return out


def resolve_resume_path(resume, checkpoint_root):
    '''
    Resolve `--resume v6` to the unique checkpoints/v6_*/ directory (an
    existing path is returned as it is).
    '''
    if os.path.exists(resume):
        return resume
    dps = [os.path.join(checkpoint_root, dn) for dn in os.listdir(checkpoint_root)]
    dps = [dp for dp in dps if os.path.isdir(dp) and (resume + '_') in dp]
    assert len(dps) == 1, f'Expected exactly one matching checkpoint folder, got {dps}'
    return dps[0]
