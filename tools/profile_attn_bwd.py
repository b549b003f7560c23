#!/usr/bin/env python3
'''
Where the attention backward's time goes on one NVIDIA GPU, f32 and bf16
(fused_decoder_dtype='bf16') modes, with torch.profiler.

    python3 tools/profile_attn_bwd.py [--reps 3] [--f32] [--plain] [--sattn]

At chip_smoke.py's train-frame shapes (gv1 / cv1 decoder weights from its
seeded models): o4d_attn_bwd / o4d_attn_bwd_bf16 in premul mode at the gv1
train frame (3 x 17920 queries x 531 keys, K 14, D 416, E 288) and
o4d_attn_g_bwd / o4d_attn_g_bwd_bf16 at the cv1 train frame (3 x 17203 x
2124, rows gathered by the gather kernel of the same mode). Per case, one
JSON line: the mean ms per call (CUDA events), the device time per call
of every kernel the call launches (row loader, theta's hidden layer, each
GEMM instantiation, the softmax backward, the column sums and reduces, the
inverse index and per-key sums) and the GEMM launches of one call by path
(ops/attention.py GEMM_PATHS; empty where the backward does not count
them). --f32: the f32 cases alone, the gv1 frame also per-row. --plain:
beside each f32 case its plain version's ms (attn_bwd_plain /
attn_g_bwd_plain one example at a time, as chip_smoke.py; sattn_bwd_plain
whole) and the kernel's largest gradient error over max(1, max|plain|).
--sattn: also o4d_sattn_bwd at the encoder's four self-attention blocks of
the gv1 train step (chip_smoke.py _SATTN_SHAPES, B 3, K 16). Prints the
card's nvidia-smi name and power limit. Needs CUDA; imports nothing of JAX.
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


def gemm_launches(fn):
    '''{counter: launches} of one call of fn by GEMM path, from the
    process's counters (ops/attention.py GEMM_PATHS); empty where the
    backward does not count them.'''
    from occlusions4d_torch.utils import profiling
    profiling.record_spans(True)
    m = profiling.mark()
    try:
        fn()
        return {k: v for k, v in profiling.counters(since=m).items()
                if k.startswith('kernel.gemm_')}
    finally:
        profiling.record_spans(False)


def scaled_err(got, want):
    '''The largest error of the three results over max(1, max|plain|) each.'''
    pairs = [(got[0], want[0]), (got[1], want[1])] + [(got[2][n], want[2][n]) for n in want[2]]
    return max(float((a - b).abs().max()) / max(1.0, float(b.abs().max())) for a, b in pairs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--reps', type=int, default=3)
    ap.add_argument('--f32', action='store_true')
    ap.add_argument('--plain', action='store_true')
    ap.add_argument('--sattn', action='store_true')
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
    t_sattn = importlib.import_module('occlusions4d_torch.ops.self_attention')
    t_knn = importlib.import_module('occlusions4d_torch.ops.knn')
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    _build.build_all()
    rng = np.random.RandomState(0)
    bf = torch.bfloat16
    dtypes = (torch.float32,) if args.f32 else (torch.float32, bf)

    def rand(*shape, scale=None):
        a = rng.rand(*shape) * scale - scale / 2 if scale else rng.randn(*shape)
        return torch.tensor(a.astype(np.float32), device=dev)
    cases, plains = {}, {}
    with torch.no_grad():
        for model, cfg_kw, seed, N, M in (('gv1', cs._GV1, 1, 17920, 531),
                                          ('cv1', cs._CV1, 4, cs._CV1_N, cs._CV1_M)):
            encoder, decoder, dec_args = cs.seeded_models(torch, TrainConfig(**cfg_kw), dev,
                                                          seed)
            params = decoder.pt_blocks[0].layer2.kernel_params()
            B, D, E, K = 3, dec_args['d_latent'], dec_args['d_latent_local'], 14
            pos2, feats2, qpos = rand(B, M, 3, scale=10.0), rand(B, M, E), rand(B, N, 3,
                                                                              scale=10.0)
            knn = t_attn.knn_extract(qpos, pos2, K)
            q_proj, go = rand(B, N, D), rand(B, N, D)
            for cd in dtypes:
                tag = 'bf16' if cd == bf else 'f32'
                if model == 'gv1':
                    kv = torch.cat([feats2 @ params['to_k']['kernel'],
                                    feats2 @ params['to_v']['kernel']], -1).contiguous()
                    modes = ((True, kv), (False, feats2)) if args.f32 else ((True, kv),)
                    for premul, kvm in modes:
                        a = (qpos, q_proj, knn[0], pos2, kvm, params, K, premul, go)
                        name = f'attn_bwd_{"premul" if premul else "per_row"}_{tag}_gv1'
                        cases[name] = lambda a=a, cd=cd: t_attn.attn_bwd(*a, cd)
                        plains[name] = lambda a=a: cs.plain_per_example(
                            torch, t_attn.attn_bwd_plain, a)
                else:
                    g = t_attn.knn_gather_rows(pos2, feats2, knn, K, compute_dtype=cd)
                    a = (qpos, q_proj, g, params, K, go)
                    cases[f'attn_g_bwd_{tag}_cv1'] = lambda a=a, cd=cd: t_attn.attn_g_bwd(*a, cd)
                    plains[f'attn_g_bwd_{tag}_cv1'] = lambda a=a: cs.plain_per_example(
                        torch, t_attn.attn_g_bwd_plain, a)
            if args.sattn and model == 'gv1':
                for name, Bs, Ns, blk in cs._SATTN_SHAPES[:4]:
                    sp = {n: {leaf: t.detach().contiguous() for leaf, t in d.items()}
                          for n, d in encoder.blocks[blk].layer2.kernel_params().items()}
                    Ds = encoder.blocks[blk].layer2.dim
                    pos, x = rand(Bs, Ns, 3, scale=4.0), rand(Bs, Ns, Ds)
                    q, gos = rand(Bs, Ns, Ds), rand(Bs, Ns, Ds)
                    _, idx = t_knn.knn(pos, pos, 16)
                    gf = t_attn.gather_rows(x, idx)
                    rel = (pos[:, :, None] - t_knn.gather_neighbors(pos, idx)).contiguous()
                    a = (q, gf, rel, sp, 16, gos)
                    cases[f'sattn_bwd_f32_{name}'] = lambda a=a: t_sattn.sattn_bwd(*a)
                    plains[f'sattn_bwd_f32_{name}'] = lambda a=a: t_sattn.sattn_bwd_plain(
                        *a[:4], a[5])
        smi = cs.nvidia_smi()
        for name, fn in cases.items():
            fn()
            line = dict(case=name, ms=cs.cuda_ms(torch, fn, args.reps),
                        kernels_ms=kernel_ms(torch, fn, args.reps),
                        gemm_launches=gemm_launches(fn), gpu=smi)
            if args.plain and '_f32_' in name:
                with torch.enable_grad():  # the plain versions differentiate the forward.
                    got, want = fn(), plains[name]()
                    torch.cuda.synchronize()
                    line['max_scaled_err_vs_plain'] = scaled_err(got, want)
                    del got, want
                    line['plain_ms'] = cs.cuda_ms(torch, plains[name], 2)
            print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
