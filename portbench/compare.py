'''
The comparison that decides `correct`: each number the program's run is
held to, worked out from its readings and the reference's, beside its limit.

Train cells compare, for the first steps of the run:
  loss_gap    the first step's |loss - reference loss| / |reference loss|
              (the later steps' losses move with AdamW's first update, in
              which a leaf's round-off gradient makes an lr-size move of
              either sign: change_gap holds the steps after the first);
  grad_gap    the first step's clipped gradient, leaf by leaf: the largest
              |norm - reference norm| / max(reference norm, the median
              leaf's reference norm);
  change_gap  the parameters' change over the steps, leaf by leaf, as
              grad_gap; leaves whose reference gradient is under a
              thousandth of the median leaf's are left out (their moves
              under AdamW are round-off: a softmax-invariant bias).
Scene cells compare, for the sampled scenes:
  encoder_gap the abstract cloud and the global feature: the largest
              |value - reference| / max(1, |reference|);
  output_gap  the squashed outputs of every query, likewise.
'''

import math
import statistics

import torch

NEGLIGIBLE_GRAD = 1e-3


def worst(values):
    '''The largest value; inf where any is not a finite number.'''
    values = list(values)
    return max(values) if all(math.isfinite(v) for v in values) else math.inf


def loss_gaps(losses, ref_losses):
    '''Each step's |loss - reference| / |reference|.'''
    return [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(losses, ref_losses)]


def leaf_gap(norms, ref_norms, names=None):
    '''Worst leaf's |norm - reference| / max(reference, median reference).'''
    median = statistics.median(ref_norms.values())
    names = ref_norms if names is None else names
    return worst(abs(norms[n] - ref_norms[n]) / max(ref_norms[n], median) for n in names)


def counted_leaves(ref_grad_norms):
    '''Leaves whose reference gradient is not round-off next to the median's.'''
    median = statistics.median(ref_grad_norms.values())
    return [n for n, g in ref_grad_norms.items() if g >= NEGLIGIBLE_GRAD * median]


def train_readings(prog, ref):
    '''prog and ref: dict(losses, grad_norms, change_norms) (reference/train.py
    run_steps' layout). :return {number: value}.'''
    if set(prog['grad_norms']) != set(ref['grad_norms']):
        raise ValueError('the program\'s leaves differ from the reference\'s')
    return dict(loss_gap=worst(loss_gaps(prog['losses'], ref['losses'])[:1]),
                grad_gap=leaf_gap(prog['grad_norms'], ref['grad_norms']),
                change_gap=leaf_gap(prog['change_norms'], ref['change_norms'],
                                    counted_leaves(ref['grad_norms'])))


def scaled_gap(values, ref):
    '''Largest |value - reference| / max(1, |reference|) of two tensors.'''
    values = torch.as_tensor(values, device=ref.device).to(torch.float64)
    ref = ref.to(torch.float64)
    if values.shape != ref.shape:
        return math.inf
    return worst([float(((values - ref).abs() / ref.abs().clamp(min=1.0)).max())])


def checks(readings, limits):
    '''[{name, value, limit}] in the limits' order, and whether every value
    is a finite number within its limit.'''
    rows = [dict(name=n, value=readings.get(n, math.nan), limit=lim)
            for n, lim in limits.items()]
    ok = all(math.isfinite(r['value']) and r['value'] <= r['limit'] for r in rows)
    return rows, ok
