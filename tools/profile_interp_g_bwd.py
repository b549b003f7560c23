#!/usr/bin/env python3
'''
The gathered interpolation's backward (o4d_interp_g_bwd) beside the card's
write ceiling for its buffer, on one NVIDIA GPU.

    python3 tools/profile_interp_g_bwd.py [--reps 20]

At chip_smoke.py's cv1 train frame (3 examples x 17203 queries, K_ext 14,
k 8, rows of 291 floats: 841 MB of dg), with seeded squared distances and
cotangents: the kernel's time (CUDA events), its plain version's, the
library call twice (torch.mul into the zeroed buffer's row slice; the whole
function with the buffer and the weights made inside the timing), and the
write ceiling (dg.zero_() and o4d_fill16, with and without evict-first
stores); whether the kernel equals its plain version bit for bit. One JSON
line, then the card's nvidia-smi name and power limit. Needs CUDA; imports
nothing of JAX.
'''

import argparse
import importlib
import json
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('needs CUDA', file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    import chip_smoke as cs
    t_attn = importlib.import_module('occlusions4d_torch.ops.attention')
    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    B, N, K, KI, E = 3, cs._CV1_N, 14, 8, 288
    kd = torch.tensor(np.sort(rng.rand(B, N, K).astype(np.float32) * 4, -1), device=dev)
    go = torch.tensor(rng.randn(B, N, E).astype(np.float32), device=dev)

    def kernel():
        return t_attn.interp_g_bwd(kd, go, KI, K, E, 1e-4)
    out, ref = kernel(), t_attn.interp_g_bwd_plain(kd, go, KI, K, E, 1e-4)
    torch.cuda.synchronize()
    bit_equal = bool(torch.equal(out, ref))
    del ref
    res = dict(shape=[B, N, KI, K, E + 3], bytes=4 * out.numel(), bit_equal_to_plain=bit_equal,
               ms=cs.cuda_ms(torch, kernel, args.reps),
               **cs.interp_g_bwd_write_times(torch, t_attn, kd, go, KI, E, out, args.reps))
    res['tb_s'] = res['bytes'] / res['ms'] / 1e9
    smi = cs.nvidia_smi()
    print(json.dumps(dict(res, gpu=smi)), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
