#!/usr/bin/env python3
'''
Where the attention backward's time goes on one NVIDIA GPU, f32 and bf16
(fused_decoder_dtype='bf16') modes, with torch.profiler.

    python3 tools/profile_attn_bwd.py [--reps 3]

At chip_smoke.py's train-frame shapes (gv1 / cv1 decoder weights from its
seeded models): o4d_attn_bwd / o4d_attn_bwd_bf16 in premul mode at the gv1
train frame (3 x 17920 queries x 531 keys, K 14, D 416, E 288) and
o4d_attn_g_bwd / o4d_attn_g_bwd_bf16 at the cv1 train frame (3 x 17203 x
2124, rows gathered by the gather kernel of the same mode). Per case, one
JSON line: the mean ms per call (CUDA events) and the device time per call
of every kernel the call launches (row loader, theta's hidden layer, each
GEMM instantiation, the softmax backward, the column sums and reduces, the
inverse index and per-key sums). Prints the card's nvidia-smi name and
power limit. Needs CUDA; imports nothing of JAX.
'''

import argparse
import importlib
import json
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, 'tools'))

from profile_attn_fwd import kernel_ms  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--reps', type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('needs CUDA', file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    import chip_smoke as cs
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.ops import _build
    t_attn = importlib.import_module('occlusions4d_torch.ops.attention')
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    _build.build_all()
    rng = np.random.RandomState(0)
    bf = torch.bfloat16

    def rand(*shape, scale=None):
        a = rng.rand(*shape) * scale - scale / 2 if scale else rng.randn(*shape)
        return torch.tensor(a.astype(np.float32), device=dev)
    cases = {}
    with torch.no_grad():
        for model, cfg_kw, seed, N, M in (('gv1', cs._GV1, 1, 17920, 531),
                                          ('cv1', cs._CV1, 4, cs._CV1_N, cs._CV1_M)):
            _, decoder, dec_args = cs.seeded_models(torch, TrainConfig(**cfg_kw), dev, seed)
            params = decoder.pt_blocks[0].layer2.kernel_params()
            B, D, E, K = 3, dec_args['d_latent'], dec_args['d_latent_local'], 14
            pos2, feats2, qpos = rand(B, M, 3, scale=10.0), rand(B, M, E), rand(B, N, 3,
                                                                              scale=10.0)
            knn = t_attn.knn_extract(qpos, pos2, K)
            q_proj, go = rand(B, N, D), rand(B, N, D)
            for cd in (torch.float32, bf):
                tag = 'bf16' if cd == bf else 'f32'
                if model == 'gv1':
                    kv = torch.cat([feats2 @ params['to_k']['kernel'],
                                    feats2 @ params['to_v']['kernel']], -1).contiguous()
                    cases[f'attn_bwd_premul_{tag}_gv1'] = (
                        lambda kv=kv, pos2=pos2, ki=knn[0], qpos=qpos, q_proj=q_proj, go=go,
                        params=params, cd=cd: t_attn.attn_bwd(qpos, q_proj, ki, pos2, kv,
                                                              params, K, True, go, cd))
                else:
                    g = t_attn.knn_gather_rows(pos2, feats2, knn, K, compute_dtype=cd)
                    cases[f'attn_g_bwd_{tag}_cv1'] = (
                        lambda g=g, qpos=qpos, q_proj=q_proj, go=go, params=params, cd=cd:
                        t_attn.attn_g_bwd(qpos, q_proj, g, params, K, go, cd))
        smi = cs.nvidia_smi()
        for name, fn in cases.items():
            fn()
            ms = cs.cuda_ms(torch, fn, args.reps)
            print(json.dumps(dict(case=name, ms=ms, kernels_ms=kernel_ms(torch, fn, args.reps),
                                  gpu=smi)), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
