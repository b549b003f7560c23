'''
Native checkpoints of the JAX package's layout, read and written, and the
mapping between its parameter trees and this package's state_dicts.

Native .pkl checkpoints come in two layouts: the legacy bare pickle
{epoch, state, meta} and the crc32 envelope {format, version, crc32, payload}
whose payload is that pickle. save_checkpoint writes the envelope, as
model_{epoch}.pkl and the rolling checkpoint.pkl, each through a tmp file and
os.replace. state is {'params', 'opt_state', 'step'}: params the flax-layout
{'encoder', 'decoder'} tree of numpy arrays (to_jax_params), opt_state the
port's AdamW as plain dicts {'mu', 'nu' (the params' layout), 'count'}.

A JAX-written file pickles optax's state, whose classes (NamedTuples) do not
exist where the port runs. The reader therefore unpickles with a restricted
Unpickler: numpy's array machinery and plain containers load as
themselves, every other class becomes an inert placeholder that keeps the
arguments it was built from (a NamedTuple's fields), so adam_state can find
ScaleByAdamState's count, mu and nu without optax. (Unpickle only files this
project wrote: pickle can run code.) The JAX Trainer cannot resume from the
port's opt_state dicts; its evaluation reads the port's files.

from_jax_params maps a flax variables tree ({'params', ['batch_stats']}) onto
the reference torch key layout (the same keys as the JAX package's
export_torch_state_dict: kernels transposed to (out, in), norm scale ->
weight, batch statistics -> running_mean/var, decoder 'backbone/' dropped);
to_jax_params is its inverse (the JAX package's import_torch_state_dict),
with the decoder's legacy 'pt_block.' keys read as 'pt_blocks.0.'.

Reference checkpoints (.pth, the layout of the reference's train.py and of
the released weights): one torch.save dict {pcl_net, implicit_net (state
dicts), pcl_args, implicit_args, dset_args (constructor and dataset
kwargs), args (an argparse.Namespace), epoch, optimizer, lr_scheduler,
scaler}. load_reference_checkpoint reads it with torch.load(weights_only=
True), the allowed globals being the dict's own (argparse.Namespace, and
collections.Counter in MultiStepLR's state); a file holding any other
global is refused, as the .pkl reader refuses to build foreign classes.

resolve_checkpoint_file picks the file of a run directory as the JAX
load_models does: its pkl epochs, else model_{epoch}.pth / checkpoint.pth;
a directory whose newest (or requested) epoch is an orbax store raises.
'''

import argparse
import collections
import io
import os
import pickle
import re
import zlib

import numpy as np
import torch

__all__ = ['load_checkpoint', 'load_native_checkpoint', 'save_checkpoint', 'adam_state',
           'from_jax_params', 'to_jax_params', 'resolve_resume_path',
           'newest_native_layout', 'resolve_checkpoint_file', 'load_reference_checkpoint']

_CKPT_FORMAT = 'o4d_ckpt'
_CKPT_VERSION = 1
_SAFE_BUILTINS = {'dict', 'list', 'tuple', 'set', 'frozenset', 'int', 'float',
                  'complex', 'str', 'bytes', 'bytearray', 'bool', 'slice', 'range'}


class _Inert:
    '''Stand-in for a pickled class that does not exist here. It keeps the
    arguments it was built from (`args`: a NamedTuple's fields, which pickle
    passes to __new__) and its pickled state.'''

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args = args
        return obj

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


def _pkl_epochs(dirpath):
    out = []
    for name in os.listdir(dirpath):
        stem = name[len('model_'):-len('.pkl')]
        if name.startswith('model_') and name.endswith('.pkl') and stem.isdigit():
            out.append(int(stem))
    return sorted(out)


def newest_native_layout(dirpath, epoch=-1):
    ''''pkl' or 'orbax', the layout of a run directory that holds the
    requested epoch (pkl on a tie), or for epoch < 0 its newest epoch (pkl
    on a tie, or when only a rolling checkpoint.pkl exists); None when it
    holds neither.'''
    if not os.path.isdir(dirpath):
        return None
    pe = _pkl_epochs(dirpath)
    oe = [int(n[len('model_'):-len('.orbax')]) for n in os.listdir(dirpath)
          if n.startswith('model_') and n.endswith('.orbax')
          and n[len('model_'):-len('.orbax')].isdigit()]
    if epoch >= 0:
        return 'pkl' if epoch in pe else ('orbax' if epoch in oe else None)
    if oe and max(oe) > max(pe, default=-1):
        return 'orbax'
    if pe or os.path.isfile(os.path.join(dirpath, 'checkpoint.pkl')):
        return 'pkl'
    return None


def resolve_checkpoint_file(path, epoch=-1):
    '''
    The checkpoint file of `path` (the JAX load_models' arbitration): a file
    as it is; a directory holding the pkl layout -> model_{epoch}.pkl, or
    checkpoint.pkl for epoch < 0; any other directory -> model_{epoch}.pth,
    or checkpoint.pth. Raises NotImplementedError where the directory's
    requested or newest epoch is an orbax store (orbax is not installed
    where the port runs).
    '''
    if not os.path.isdir(path):
        return path
    layout = newest_native_layout(path, epoch)
    if layout == 'orbax':
        raise NotImplementedError(f'{path}: its {"newest" if epoch < 0 else "requested"} '
                                  'epoch is an orbax store, which the port does not read '
                                  '(ROADMAP.md Queue 1 item 5)')
    ext = 'pkl' if layout == 'pkl' else 'pth'
    return os.path.join(path, f'model_{epoch}.{ext}' if epoch >= 0 else f'checkpoint.{ext}')


def load_checkpoint(path, epoch=-1):
    '''
    :param path: a .pkl file, or a checkpoint directory (model_{epoch}.pkl, or
        the rolling checkpoint.pkl when epoch < 0).
    :return the pickled dict(epoch, state, meta), its envelope's crc32
        checked; classes that do not exist here are _Inert placeholders.
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
    return obj


def load_native_checkpoint(path, epoch=-1):
    '''
    :return dict(epoch, params, meta) of load_checkpoint(path, epoch): params
        is the {'encoder', 'decoder'} tree of flax variables dicts of numpy
        arrays.
    '''
    obj = load_checkpoint(path, epoch)
    return dict(epoch=obj['epoch'], params=obj['state']['params'], meta=obj['meta'])


def save_checkpoint(output_dir, epoch, state, meta=None):
    '''Write {epoch, state, meta} in the crc32 envelope as model_{epoch}.pkl
    and the rolling checkpoint.pkl, each atomically (a tmp file, then
    os.replace). :param state: a tree of dicts, lists and numpy arrays.'''
    os.makedirs(output_dir, exist_ok=True)
    payload = pickle.dumps({'epoch': int(epoch), 'state': state, 'meta': meta or {}},
                           protocol=4)
    envelope = {'format': _CKPT_FORMAT, 'version': _CKPT_VERSION,
                'crc32': zlib.crc32(payload), 'payload': payload}
    for name in (f'model_{epoch}.pkl', 'checkpoint.pkl'):
        final = os.path.join(output_dir, name)
        with open(final + '.tmp', 'wb') as f:
            pickle.dump(envelope, f, protocol=4)
        os.replace(final + '.tmp', final)


def _arrays_only(tree):
    '''A nested dict with every leaf that is not an array (optax's
    MaskedNode placeholders) left out.'''
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _arrays_only(v)
            if v:
                out[k] = v
        elif isinstance(v, (np.ndarray, np.generic)):
            out[k] = v
    return out


def adam_state(opt_state):
    '''
    :param opt_state: state['opt_state'] of a checkpoint: the port's dict, or
        the JAX package's optax chain (placeholders here).
    :return dict(count (int), mu, nu): the moments in the params' flax layout.
    '''
    if isinstance(opt_state, dict) and {'mu', 'nu', 'count'} <= set(opt_state):
        return dict(count=int(opt_state['count']), mu=opt_state['mu'], nu=opt_state['nu'])
    stack = [opt_state]
    while stack:
        node = stack.pop()
        if isinstance(node, _Inert):
            if type(node).__name__ == 'ScaleByAdamState':
                count, mu, nu = node.args
                return dict(count=int(count), mu=_arrays_only(mu), nu=_arrays_only(nu))
            stack.extend(node.args)
            stack.append(getattr(node, 'state', None))
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif isinstance(node, dict):
            stack.extend(node.values())
    raise ValueError('the checkpoint\'s optimizer state holds no Adam moments')


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


def _torch_state(variables):
    '''flax variables (or a bare params tree) -> OrderedDict torch key ->
    float32 tensor (copies).'''
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
    return out


def from_jax_params(variables, net):
    '''
    :param variables: flax variables {'params': ..., ['batch_stats': ...]}
        (numpy or array-like leaves), or a bare params tree.
    :param net: the torch module the state_dict is for (its keys are checked).
    :return collections.OrderedDict state_dict of float32 tensors (copies).
    '''
    out = _torch_state(variables)
    expected = set(net.state_dict().keys())
    if set(out) != expected:
        raise KeyError(f'parameter tree does not fit {type(net).__name__}: '
                       f'missing {sorted(expected - set(out))}, '
                       f'unexpected {sorted(set(out) - expected)}')
    return out


def jax_moments_to_torch(tree, net):
    '''An optimizer moment in the flax layout of `net`'s parameters ->
    {parameter name: float32 tensor}, checked against net.named_parameters().'''
    out = _torch_state(tree)
    expected = {n for n, _ in net.named_parameters()}
    if set(out) != expected:
        raise KeyError(f'moment tree does not fit {type(net).__name__}: '
                       f'missing {sorted(expected - set(out))}, '
                       f'unexpected {sorted(set(out) - expected)}')
    return out


_DECODER_BACKBONE = ('lin_in', 'lin_out', 'lin_z', 'blocks')


def _flax_path(key, decoder):
    '''torch key without its leaf -> flax module path: list indices become
    name suffixes ('blocks.3.mlp.0' -> blocks_3/mlp_0), and a decoder's
    backbone layers move under 'backbone'.'''
    parts = []
    for p in key.split('.'):
        if p.isdigit() and parts:
            parts[-1] = parts[-1] + '_' + p
        else:
            parts.append(p)
    if decoder and key.split('.')[0] in _DECODER_BACKBONE:
        parts = ['backbone'] + parts
    return tuple(parts)


def _nest(flat):
    root = {}
    for path, val in flat.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = val
    return root


_LEGACY = re.compile(r'^pt_block\.')


def to_jax_params(state_dict, decoder=False):
    '''
    Inverse of from_jax_params (the JAX package's import_torch_state_dict):
    a torch state_dict, or a dict of the same keys (an optimizer moment),
    -> flax variables {'params': ..., ['batch_stats': ...]} of float32 numpy
    arrays (copies). A 2-D weight is a kernel (transposed), a 1-D weight a
    norm scale, a bias a norm's when its weight is 1-D. :param decoder: the
    state is a LocalImplicitField's (its backbone layers nest under
    'backbone').
    '''
    if decoder:   # the legacy single-block name.
        state_dict = {_LEGACY.sub('pt_blocks.0.', k): v for k, v in state_dict.items()}
    params, stats = {}, {}
    for key, val in state_dict.items():
        mod, leaf = key.rsplit('.', 1)
        if leaf == 'num_batches_tracked':
            continue
        path = _flax_path(mod, decoder)
        arr = np.array(val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else val,
                       dtype=np.float32, copy=True)
        if leaf == 'weight':
            params[path + (('kernel',) if arr.ndim == 2 else ('norm', 'scale'))] = \
                arr.T.copy() if arr.ndim == 2 else arr
        elif leaf == 'bias':
            w = state_dict.get(mod + '.weight')
            norm = w is not None and len(w.shape) == 1
            params[path + (('norm', 'bias') if norm else ('bias',))] = arr
        elif leaf in ('running_mean', 'running_var'):
            stats[path + ('norm', leaf[len('running_'):])] = arr
        else:
            raise ValueError(f'Unrecognized torch leaf: {key}')
    out = {'params': _nest(params)}
    if stats:
        out['batch_stats'] = _nest(stats)
    return out


# The globals a reference checkpoint holds besides tensors and containers:
# its args, and the Counter of MultiStepLR's milestones.
_REFERENCE_GLOBALS = (argparse.Namespace, collections.Counter)


def load_reference_checkpoint(path):
    '''
    Read a reference-layout .pth (torch.load with weights_only=True, the
    globals of _REFERENCE_GLOBALS allowed; any other raises ValueError
    naming it).
    :return dict(encoder_variables, decoder_variables (flax variables of
        float32 numpy arrays, to_jax_params), pcl_args, implicit_args,
        dset_args, train_args (the file's args), epoch (-1 when absent)):
        the JAX package's load_reference_checkpoint's fields.
    '''
    import torch
    try:
        with torch.serialization.safe_globals(list(_REFERENCE_GLOBALS)):
            ckpt = torch.load(path, map_location='cpu', weights_only=True)
    except pickle.UnpicklingError as e:
        found = re.search(r'GLOBAL (\S+)', str(e))
        allowed = ', '.join(f'{g.__module__}.{g.__qualname__}' for g in _REFERENCE_GLOBALS)
        raise ValueError(f'{path}: holds the global '
                         f'{found.group(1) if found else "(unknown)"}, which a reference '
                         f'checkpoint does not (allowed: {allowed})') from e
    return dict(
        encoder_variables=to_jax_params(ckpt['pcl_net']),
        decoder_variables=to_jax_params(ckpt['implicit_net'], decoder=True),
        pcl_args=ckpt.get('pcl_args'),
        implicit_args=ckpt.get('implicit_args'),
        dset_args=ckpt.get('dset_args'),
        train_args=ckpt.get('args'),
        epoch=ckpt.get('epoch', -1),
    )


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
