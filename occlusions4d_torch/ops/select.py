'''
Fixed-capacity selection primitives (port of occlusions4d_tpu/ops/select.py):
boolean-filtered pools become masks and weighted inverse-CDF draws, so no
shape depends on the data and nothing waits for the host. Every function
works on a leading batch axis: (B, N) masks, (B, n) results.

  valid_first_order  stable permutation putting valid entries first;
  take_valid         the first n valid rows, duplicated cyclically when short
                     (the reference's select_safely);
  masked_choice      n draws with replacement from the valid entries,
                     uniform or weighted, as indices into the original array.
'''

import torch

__all__ = ['valid_first_order', 'take_valid', 'masked_choice',
           'masked_choice_from_uniforms']


def valid_first_order(valid):
    '''(B, N) bool -> (B, N) int64 stable permutation, valid entries first.'''
    return torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)


def take_valid(x, valid, n_out):
    '''
    :param x (B, N, D); valid (B, N) bool; n_out (int).
    :return (rows (B, n_out, D), count (B,)): the first n_out valid rows, valid
        rows repeated cyclically when there are fewer; count = min(valid, n_out).
    '''
    order = valid_first_order(valid)
    cnt = valid.sum(-1)
    pos = torch.arange(n_out, device=x.device)[None] % torch.clamp(cnt, min=1)[:, None]
    pick = torch.gather(order, 1, pos)
    rows = torch.gather(x, 1, pick[..., None].expand(-1, -1, x.shape[-1]))
    return rows, torch.clamp(cnt, max=n_out)


def masked_choice_from_uniforms(valid, u, weights=None):
    '''
    Inverse-CDF draws from the valid entries given uniforms in [0, 1).
    :param valid (B, N) bool; u (B, n) f32; weights (B, N) or None.
    :return (idx (B, n) int64, ok (B,) bool): ok is False where no entry has
        weight (the indices then point at entry 0 and must be discarded).
    '''
    w = torch.where(valid, torch.ones_like(valid, dtype=torch.float32)
                    if weights is None else weights.to(torch.float32),
                    torch.zeros((), dtype=torch.float32, device=valid.device))
    ok = w.sum(-1) > 0
    # A float cumsum can dip by an ulp (non-monotone cdf): the running max
    # restores the sorted-input contract of searchsorted, so a draw never
    # lands on a zero-weight entry.
    cdf = torch.cummax(torch.cumsum(w, dim=-1), dim=-1).values
    last = cdf[:, -1:]
    u = u * torch.clamp(last, min=1e-30)
    # Strictly below the last cdf value: the product can round up to it.
    u = torch.minimum(u, torch.nextafter(last, torch.zeros_like(last)))
    idx = torch.searchsorted(cdf, u.contiguous(), right=True)
    return torch.clamp(idx, max=valid.shape[-1] - 1), ok


def masked_choice(generator, valid, n_draw, weights=None):
    '''n_draw draws per example with replacement from the valid entries,
    uniform or weighted; uniforms from `generator`. Same result as
    masked_choice_from_uniforms.'''
    u = torch.rand((valid.shape[0], n_draw), generator=generator, device=valid.device)
    return masked_choice_from_uniforms(valid, u, weights)
