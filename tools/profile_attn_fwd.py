#!/usr/bin/env python3
'''
Where the attention forward's time goes on one NVIDIA GPU, f32 and bf16
(precision='fast') modes, with torch.profiler.

    python3 tools/profile_attn_fwd.py [--reps 3] [--only attn|sattn]

At chip_smoke.py's shapes (gv1 decoder weights from its seeded models):
o4d_attn / o4d_attn_bf16 in premul mode at one gv1 decode chunk (32768
queries x 531 keys, K 14, D 416, E 288) and o4d_attn_g / o4d_attn_g_bf16 at
one cv1 chunk (32768 x 2124, rows gathered by the gather kernel of the same
mode); the encoder's fused self-attention, o4d_sattn / o4d_sattn_bf16, at
chip_smoke.py's five blocks (_SATTN_SHAPES: the gv1 train step's four, B 3,
D 36 to 288, and the n57344 step's first; K 16, the seeded encoder's
weights, neighbours from the kNN kernel). Per case, one JSON line: the mean ms per call (CUDA events) and the
device time per call of every kernel the call launches (row loader, theta,
the fragment-order layouts, the tile, the softmax combine). Prints the
card's nvidia-smi name and power limit. Needs CUDA; imports nothing of JAX.
'''

import argparse
import importlib
import json
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_ms(torch, fn, reps):
    '''{kernel name: device ms per call} of `reps` calls of fn.'''
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace('(anonymous namespace)::', '').replace('void ', '')
            name = name.split('(')[0][:80]
            us = e.time_range.end - e.time_range.start
            out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--reps', type=int, default=3)
    ap.add_argument('--only', choices=('attn', 'sattn'), default=None)
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

    def cloud(n):
        return torch.tensor(rng.rand(1, n, 3).astype(np.float32) * 10 - 5, device=dev)
    encoder, decoder, dec_args = cs.seeded_models(torch, TrainConfig(**cs._GV1), dev, 1)
    params = decoder.pt_blocks[0].layer2.kernel_params()
    D, E, K, N = dec_args['d_latent'], dec_args['d_latent_local'], 14, cs._CHUNK
    q_proj = torch.tensor(rng.randn(1, N, D).astype(np.float32), device=dev)
    qpos = cloud(N)
    cases = {}
    with torch.no_grad():
        for M in ((531, cs._CV1_M) if args.only != 'sattn' else ()):
            pos2 = cloud(M)
            feats2 = torch.tensor(rng.randn(1, M, E).astype(np.float32), device=dev)
            knn = t_attn.knn_extract(qpos, pos2, K)
            if M == 531:
                kv = torch.cat([feats2 @ params['to_k']['kernel'],
                                feats2 @ params['to_v']['kernel']], -1).contiguous()
                for bf16 in (False, True):
                    cases[f'attn_premul_{"bf16" if bf16 else "f32"}_gv1'] = (
                        lambda kv=kv, pos2=pos2, ki=knn[0], bf16=bf16: t_attn._attn_cuda(
                            qpos, q_proj, ki, pos2, kv, params, K, True, bf16))
            else:
                for bf16 in (False, True):
                    g = t_attn.knn_gather_rows(pos2, feats2, knn, K,
                                               compute_dtype=torch.bfloat16 if bf16
                                               else torch.float32)
                    cases[f'attn_g_{"bf16" if bf16 else "f32"}_cv1'] = (
                        lambda g=g, bf16=bf16: t_attn._attn_g_cuda(qpos, q_proj, g, params, K,
                                                                   bf16))
        t_sattn = importlib.import_module('occlusions4d_torch.ops.self_attention')
        t_knn = importlib.import_module('occlusions4d_torch.ops.knn')
        for name, B, N, blk in (cs._SATTN_SHAPES if args.only != 'attn' else ()):
            att = encoder.blocks[blk].layer2
            p = {n: {leaf: t.detach().contiguous() for leaf, t in d.items()}
                 for n, d in att.kernel_params().items()}
            pos = torch.tensor(rng.rand(B, N, 3).astype(np.float32) * 4 - 2, device=dev)
            x = torch.tensor(rng.randn(B, N, att.dim).astype(np.float32), device=dev)
            q = torch.tensor(rng.randn(B, N, att.dim).astype(np.float32), device=dev)
            _, idx = t_knn.knn(pos, pos, 16)
            gf = t_attn.gather_rows(x, idx)
            rel = (pos[:, :, None] - t_knn.gather_neighbors(pos, idx)).contiguous()
            for bf16 in (False, True):
                cd = torch.bfloat16 if bf16 else torch.float32
                g = t_attn.round_bf16(gf) if bf16 else gf
                cases[f'sattn_{"bf16" if bf16 else "f32"}_{name}'] = (
                    lambda q=q, g=g, rel=rel, p=p, cd=cd:
                    t_sattn.fused_gathered_attention(q, g, rel, p, 16, compute_dtype=cd))
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
