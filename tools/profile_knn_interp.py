#!/usr/bin/env python3
'''
The brute-force kNN (o4d_knn_brute) and the index-route interpolation
(o4d_interp, o4d_interp_bf16), with the gathered interpolation (o4d_interp_g,
o4d_interp_g_bf16) beside them, on one NVIDIA GPU.

    python3 tools/profile_knn_interp.py [--reps 20] [--variants]

First chip_smoke.py's K1 lines (knn_brute_lines: the encoder's brute
searches at B 1 and 3, the decoder's per-chunk search at M 531 and 2124
with grid-ordered and random queries, the train frames' searches; each
exact against its plain version, its wrapper and its C entry timed), then
the interpolation wrappers and entries at the gv1 decode chunk (32768
queries, 531 keys, k 8 of 14, E 288) with random and grid-ordered
queries, and the gathered ones at the cv1 chunk (2124 keys, random
queries), each against its plain version (atol 1e-5, rtol 1e-5) and the
gathered ones against the index route bit for bit. JSON lines, then the
card's nvidia-smi name and power limit. In a copy of an older tree (with
this file and chip_smoke.py copied in) it times that tree's kernels on the
same lines.

--variants also builds tools/knn_brute_variants.cu (two other designs of
the brute kNN, used by no path) with knn.cu's nvcc flags and, after each
K1 line, times on its inputs o4d_knn_brute's entry beside each variant's:
each lane's top K under a shared bound at 4, 8, 16 and 32 lanes (K 12, 14
and 16) and the ballot-filtered warp queue, each result held to the plain
version (a 'variants' line). Needs CUDA; imports nothing of JAX.
'''

import argparse
import ctypes
import importlib
import os
import subprocess
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_variants():
    '''tools/knn_brute_variants.cu built into the kernels' build directory
    with knn.cu's flags; :return the loaded library.'''
    from occlusions4d_torch.ops import _build
    src = os.path.join(_ROOT, 'tools', 'knn_brute_variants.cu')
    out = os.path.join(_build._build_dir(), 'knn_brute_variants.so')
    cmd = [_build.nvcc_path()] + _build._BASE_FLAGS + _build.SOURCES['knn'] + ['-o', out, src]
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if p.returncode != 0:
        raise RuntimeError(f'nvcc knn_brute_variants.cu failed:\n{p.stdout}')
    return ctypes.CDLL(out)


def variants_line(torch, cs, t_knn, lib, probe, reps):
    '''The each() of knn_brute_lines: o4d_knn_brute's entry at the rule's
    lanes beside probe_knn_lane_topk's at 4 to 32 lanes (K 12, 14, 16) and
    probe_knn_warpq's, on the line's inputs, each held to the plain result.'''
    def each(case, q, kk, kn, K, d_p, i_p, keys4):
        B, N, M = q.shape[0], q.shape[1], kk.shape[1]
        out_d, out_i = torch.empty_like(d_p), torch.empty_like(i_p)
        args = [q, keys4, out_d, out_i, B, N, M, K]

        def timed(lib_, name, extra):
            ms = cs.entry_ms(torch, lib_, name, args + extra, reps)
            torch.cuda.synchronize()
            return ms, bool(torch.equal(out_d, d_p)) and bool(torch.equal(out_i, i_p))
        res = {'brute': timed(lib, 'o4d_knn_brute', [t_knn.brute_lanes(B, N)])}
        if K in (12, 14, 16):
            for L in (4, 8, 16, 32):
                res[f'lane_topk_L{L}'] = timed(probe, 'probe_knn_lane_topk', [L])
        res['warp_queue'] = timed(probe, 'probe_knn_warpq', [])
        cs.emit(dict(phase='variants', case=case, shape=[B, N, M, K],
                     entry_ms={k: v[0] for k, v in res.items()},
                     exact={k: v[1] for k, v in res.items()}))
    return each


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--variants', action='store_true')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('needs CUDA', file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    import chip_smoke as cs
    t_knn = importlib.import_module('occlusions4d_torch.ops.knn')
    t_attn = importlib.import_module('occlusions4d_torch.ops.attention')
    dev = torch.device('cuda')
    smi = cs.nvidia_smi()
    cs.emit(dict(phase='env', nvidia_smi=smi, root=_ROOT))
    each = None
    if args.variants:
        probe = build_variants()
        each = variants_line(torch, cs, t_knn, t_knn._build.library('knn'), probe, args.reps)
    cs.knn_brute_lines(torch, t_knn, dev, {}, each)

    rng = np.random.RandomState(0)
    E, bf = 288, torch.bfloat16

    def cloud(n):
        return torch.tensor(rng.rand(1, n, 3).astype(np.float32) * 10 - 5, device=dev)
    pos2 = cloud(531)
    feats2 = torch.tensor(rng.randn(1, 531, E).astype(np.float32), device=dev)
    for order, qpos in (('random', cloud(cs._CHUNK)),
                        ('grid', torch.tensor(cs.grid_chunk(cs._CHUNK), device=dev))):
        ki, kd = t_attn.knn_extract(qpos, pos2, 14)
        res = {}
        for name, cd in (('interp', torch.float32), ('interp_bf16', bf)):
            def call():
                return t_attn.fused_knn_interp(qpos, pos2, feats2, 8, knn=(ki, kd),
                                               compute_dtype=cd)
            o_k = call()
            o_p = t_attn.interp_plain(ki, kd, feats2, 8, 1e-4, cd)
            torch.cuda.synchronize()
            res[name] = dict(agree=bool(torch.allclose(o_k, o_p, atol=1e-5, rtol=1e-5)),
                             ms=cs.cuda_ms(torch, call, args.reps),
                             entry_ms=cs.interp_entry_ms(torch, t_attn, name, ki, kd, feats2,
                                                         8, args.reps))
        cs.emit(dict(phase='interp', queries=order, shape=[cs._CHUNK, 531, 8, E], **res))

    pos2 = cloud(cs._CV1_M)
    feats2 = torch.tensor(rng.randn(1, cs._CV1_M, E).astype(np.float32), device=dev)
    qpos = cloud(cs._CHUNK)
    knn = t_attn.knn_extract(qpos, pos2, 14)
    g = t_attn.knn_gather_rows(pos2, feats2, knn, 14)
    res = {}
    for name, cd in (('interp_g', torch.float32), ('interp_g_bf16', bf)):
        def call():
            return t_attn.fused_knn_interp(qpos, pos2, feats2, 8, knn=knn, gathered=g,
                                           compute_dtype=cd)
        o_g = call()
        o_i = t_attn.fused_knn_interp(qpos, pos2, feats2, 8, knn=knn, compute_dtype=cd)
        o_p = t_attn.interp_g_plain(knn[1], g, 8, 1e-4, cd)
        torch.cuda.synchronize()
        res[name] = dict(agree=bool(torch.allclose(o_g, o_p, atol=1e-5, rtol=1e-5)),
                         index_route_equal=bool(torch.equal(o_g, o_i)),
                         ms=cs.cuda_ms(torch, call, args.reps),
                         entry_ms=cs.interp_g_entry_ms(torch, t_attn, name, knn[1], g, 8,
                                                       args.reps))
    cs.emit(dict(phase='interp_g', shape=[cs._CHUNK, cs._CV1_M, 8, E], **res))
    print(smi, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
