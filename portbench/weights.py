'''
The networks' weights, made by the benchmark from the seed on the device in
one draw, and handed alike to the program and to the reference.

Names and shapes are the reference networks' (reference/models.py, the
port's parameter layout): {'encoder.<name>' | 'decoder.<name>': tensor}. A
linear layer's weight and bias are uniform in +-1/sqrt(fan_in), as PyTorch
initialises nn.Linear; a layer norm's scale is 1 + 0.1 u and its shift 0.1 u.
'''

import math

import torch

from .reference.models import build_models

WEIGHT_STREAM = 1


def stream_seed(seed, stream):
    '''A generator seed of its own for each use of the run's seed.'''
    return (int(seed) * 1000003 + stream) % 2 ** 63


def reference_shapes(cfg):
    '''{name: shape} of the reference networks of cfg (built on the meta
    device: no memory, no initialisation).'''
    with torch.device('meta'):
        encoder, decoder = build_models(cfg)
    shapes = {}
    for net, mod in (('encoder', encoder), ('decoder', decoder)):
        for n, p in mod.named_parameters():
            shapes[f'{net}.{n}'] = tuple(p.shape)
    return shapes


def make_weights(cfg, seed, device):
    '''{name: float32 tensor on device} of cfg's networks from `seed`.'''
    shapes = reference_shapes(cfg)
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device).manual_seed(stream_seed(seed, WEIGHT_STREAM))
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for name, part in zip(names, torch.split(u, sizes)):
        shape = shapes[name]
        sibling = shapes.get(name.rsplit('.', 1)[0] + '.weight')
        if len(shape) == 2:                                # a linear layer's weight.
            part = part / math.sqrt(shape[1])
        elif sibling is not None and len(sibling) == 2:    # a linear layer's bias.
            part = part / math.sqrt(sibling[1])
        elif name.endswith('.weight'):                     # a layer norm's scale.
            part = 1.0 + 0.1 * part
        else:                                              # a layer norm's shift.
            part = 0.1 * part
        out[name] = part.reshape(shape).contiguous()
    return out


def load_into(modules, weights):
    '''Copy the weights into the program's networks ({'encoder': module,
    'decoder': module}), after checking that their parameters are exactly
    the weights' names and shapes.'''
    have = {f'{net}.{n}': tuple(p.shape) for net, m in modules.items()
            for n, p in m.named_parameters()}
    want = {n: tuple(t.shape) for n, t in weights.items()}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))[:8]
        raise ValueError(f'the program\'s parameters differ from the reference\'s: {diff}')
    with torch.no_grad():
        for net, m in modules.items():
            for n, p in m.named_parameters():
                p.copy_(weights[f'{net}.{n}'])
