#!/usr/bin/env python3
'''
Smoke test of the PyTorch/CUDA port (occlusions4d_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. Phases,
each printing one JSON line:

  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build: every csrc/*.cu compiled with nvcc for sm_90a (in parallel; the
     ptxas register/shared-memory report goes to chiprun_out/
     chip_smoke_build.log);
  3. kernels: each kernel's wrapper against its plain PyTorch version on the
     card at the gv1 shapes of the main path, with kernel, plain and library
     times (CUDA events);
  4. main path: gv1 at full width with seeded random weights (numpy, loaded
     through checkpoint.from_jax_params): encode a 14336-point cloud, decode
     the dense grid in chunks of 32768; launch counters are zeroed just before
     and read just after, and every kernel must have launched;
  5. anchors: both committed checkpoints through load_models and
     perform_inference on the card, against the same run on the CPU (plain
     versions);
then the card's nvidia-smi line, the {"kernels": [...]} line and, last,
{"ok": true, "device": {...}}. Any failed phase exits non-zero. Without CUDA,
or without the package beside this file, it exits non-zero and prints no
result. Imports nothing of JAX.
'''

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s, f32 CUDA-core
# and bf16 tensor-core FLOP/s.
_HBM_BPS = 3.35e12
_F32_FLOPS = 67e12
_BF16_TC_FLOPS = 989e12

# gv1 (bench.py's configuration of the JAX package).
_GV1 = dict(n_points=14336, pt_feat_dim=36, up_down_blocks=3, transition_factor=3,
            pt_num_neighbors=16, down_neighbors=12, global_size=128,
            implicit_mlp_blocks=6, cross_attn_layers=2, cross_attn_neighbors=14,
            cr_attn_type='cc', color_mode='rgb_nosigmoid', tracking_lw=1.0,
            cr_cube_bounds=5.0, min_z=-1.0, num_cr_local_feats=8)
_NUM_SAMPLE = 524288
_CHUNK = 32768
_REPLACES = {
    'knn_brute': 'occlusions4d_tpu/ops/pallas_knn.py:88; '
                 'occlusions4d_tpu/ops/pallas_attention.py:1367',
    'knn_pruned': 'occlusions4d_tpu/ops/pallas_knn.py:209',
    'fps': 'occlusions4d_tpu/ops/pallas_fps.py:39',
    'interp': 'occlusions4d_tpu/ops/pallas_attention.py:554',
    'attn': 'occlusions4d_tpu/ops/pallas_attention.py:78',
}
_SOURCE = {'knn_brute': 'knn', 'knn_pruned': 'knn', 'fps': 'fps', 'interp': 'interp',
           'attn': 'attn'}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f'nvidia-smi failed: {res.stderr}')
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps, warmup=1):
    '''Mean ms per call over `reps` calls between CUDA events.'''
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, flops, peak_flops=_F32_FLOPS):
    t_bytes = nbytes / _HBM_BPS * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def random_jax_params(net, rng):
    '''A flax-layout variables tree of seeded random numbers that fits `net`
    (the inverse of checkpoint.from_jax_params's key map).'''
    backbone = ('lin_in', 'lin_out', 'lin_z', 'blocks')
    is_decoder = hasattr(net, 'pt_blocks')
    params, stats = {}, {}
    sd = net.state_dict()
    for key, val in sd.items():
        parts = key.split('.')
        leaf = parts.pop()
        path = []
        for p in parts:
            if p.isdigit() and path:
                path[-1] = f'{path[-1]}_{p}'
            else:
                path.append(p)
        if is_decoder and path[0] in backbone:
            path = ['backbone'] + path
        shape = tuple(val.shape)
        if leaf == 'weight' and len(shape) == 2:
            fan_in = shape[1]
            dest, arr = params, rng.randn(shape[1], shape[0]) / math.sqrt(fan_in)
            path.append('kernel')
        elif leaf == 'weight':
            dest, arr = params, 1.0 + 0.1 * rng.randn(*shape)
            path += ['norm', 'scale']
        elif leaf == 'bias':
            is_norm = sd[key[:-4] + 'weight'].dim() == 1 if key[:-4] + 'weight' in sd \
                else False
            dest, arr = params, 0.1 * rng.randn(*shape)
            path += (['norm', 'bias'] if is_norm else ['bias'])
        elif leaf in ('running_mean', 'running_var'):
            dest = stats
            arr = rng.rand(*shape) + (0.5 if leaf == 'running_var' else -0.5)
            path += ['norm', leaf.split('_')[1]]
        else:
            raise ValueError(key)
        node = dest
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr.astype(np.float32)
    out = {'params': params}
    if stats:
        out['batch_stats'] = stats
    return out


def knn_agree(d_a, i_a, d_b, i_b):
    '''Indices agree except where the two distances tie within ~1 ulp.'''
    diff = i_a != i_b
    scale = d_a.abs().clamp(min=1e-30) * 2.0 ** -22
    bad = diff & ((d_a - d_b).abs() > scale)
    return int(diff.sum()), int(bad.sum())


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; nothing to run',
              file=sys.stderr)
        return 2
    sys.path.insert(0, _HERE)
    try:
        import occlusions4d_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: occlusions4d_torch not found beside this script ({e})',
              file=sys.stderr)
        return 2
    import importlib
    from occlusions4d_torch import environment
    from occlusions4d_torch.checkpoint import from_jax_params
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.evaluate import InferenceEngine, load_models, \
        perform_inference
    from occlusions4d_torch.models import build_models
    from occlusions4d_torch.models.fused import attention_params
    from occlusions4d_torch.ops import _build, blind_points_numpy
    t_knn = importlib.import_module('occlusions4d_torch.ops.knn')
    t_fps = importlib.import_module('occlusions4d_torch.ops.fps')
    t_attn = importlib.import_module('occlusions4d_torch.ops.attention')

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    t_start = time.time()

    # 1. Environment.
    smi = nvidia_smi()
    env = environment()
    emit(dict(phase='env', nvidia_smi=smi, **env))

    # 2. Build.
    t0 = time.time()
    secs = _build.build_all(verbose=True)
    os.makedirs(os.path.join(_HERE, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(_HERE, 'chiprun_out', 'chip_smoke_build.log'), 'w') as f:
        for name, log in _build.BUILD_LOGS.items():
            f.write(f'--- {name}.cu ---\n{log}\n')
    emit(dict(phase='build', seconds=time.time() - t0, per_source_s=secs,
              sources=sorted(_build.SOURCES)))

    # 3. Kernels against their plain versions at the gv1 shapes.
    rng = np.random.RandomState(0)
    rows = {}

    def cloud(n, scale=4.0):
        return torch.tensor(rng.rand(1, n, 3).astype(np.float32) * scale - scale / 2,
                            device=dev)

    def prep(q, k):
        return t_knn._prepare(q, k, None)[:3]

    # K1 brute force: encoder searches and the decoder's per-chunk search.
    knn_cases = [(4779, 14336, 12), (4779, 4779, 16), (1593, 4779, 12),
                 (1593, 1593, 16), (531, 1593, 12), (531, 531, 16),
                 (_CHUNK, 531, 14)]
    for (N, M, K) in knn_cases:
        keys = cloud(M)
        qs = keys[:, :N] if N <= M and N != _CHUNK else cloud(N)
        q, kk, kn = prep(qs, keys)
        d_k, i_k = t_knn.knn_rank(q, kk, kn, K)
        d_p, i_p = t_knn.knn_rank_plain(q, kk, kn, K)
        torch.cuda.synchronize()
        n_diff, n_bad = knn_agree(d_k, i_k, d_p, i_p)
        err = float((d_k - d_p).abs().max())
        ok = n_bad == 0 and err == 0.0
        ms = cuda_ms(torch, lambda: t_knn.knn_rank(q, kk, kn, K), 10)
        plain_ms = cuda_ms(torch, lambda: t_knn.knn_rank_plain(q, kk, kn, K), 2)
        lib_ms = cuda_ms(torch, lambda: torch.sort(torch.cdist(q, kk), dim=-1,
                                                   stable=True)[0][..., :K], 2)
        nbytes = (N * 3 + M * 3) * 4 + N * K * 8
        b_ms, b_by = bound(nbytes, 7.0 * N * M)
        emit(dict(phase='kernel', name='knn_brute', shape=[N, M, K], agree=ok,
                  index_mismatches=n_diff, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                  library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        if not ok:
            raise AssertionError(f'knn_brute disagrees at {(N, M, K)}: '
                                 f'{n_bad} untied index mismatches, err {err}')
        if N == _CHUNK:
            rows['knn_brute'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                                     shape=[N, M, K])

    # K1' pruned: the level-0 self-search.
    pts = cloud(14336)
    q, kk, kn = prep(pts, pts)
    d_k, i_k = t_knn._pruned_cuda(q, kk, kn, 16, True)
    d_p, i_p = t_knn.knn_rank_plain(q, kk, kn, 16)
    torch.cuda.synchronize()
    n_diff, n_bad = knn_agree(d_k, i_k, d_p, i_p)
    err = float((d_k - d_p).abs().max())
    ms = cuda_ms(torch, lambda: t_knn._pruned_cuda(q, kk, kn, 16, True), 10)
    plain_ms = cuda_ms(torch, lambda: t_knn.knn_rank_plain(q, kk, kn, 16), 2)
    lib_ms = cuda_ms(torch, lambda: torch.sort(torch.cdist(q, kk), dim=-1,
                                               stable=True)[0][..., :16], 2)
    # Least work: every output neighbour needs one distance; bytes dominate.
    b_ms, b_by = bound(14336 * 3 * 4 * 2 + 14336 * 16 * 8, 7.0 * 14336 * 16)
    brute_ms = cuda_ms(torch, lambda: t_knn.knn_rank(q, kk, kn, 16), 10)
    prep_ms = cuda_ms(torch, lambda: t_knn.pruned_inputs(q, kk, kn, True, 64, 256), 10)
    emit(dict(phase='kernel', name='knn_pruned', shape=[14336, 14336, 16],
              agree=n_bad == 0 and err == 0.0, index_mismatches=n_diff,
              max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
              bound_ms=b_ms, bound_by=b_by, brute_kernel_ms=brute_ms,
              sort_and_boxes_ms=prep_ms))
    if n_bad or err != 0.0:
        raise AssertionError(f'knn_pruned disagrees: {n_bad} mismatches, err {err}')
    rows['knn_pruned'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=lib_ms, shape=[14336, 14336, 16])

    # K2 FPS: the three DownTransitions.
    for (N, n_out) in ((14336, 4779), (4779, 1593), (1593, 531)):
        xyz = cloud(N)
        valid = torch.ones((1, N), dtype=torch.bool, device=dev)
        start = torch.zeros((1,), dtype=torch.int64, device=dev)
        s_k = t_fps._fps_cuda(xyz, n_out, valid, start)
        s_p = t_fps.fps_plain(xyz, n_out, valid, start)
        torch.cuda.synchronize()
        ok = bool(torch.equal(s_k, s_p))
        ms = cuda_ms(torch, lambda: t_fps._fps_cuda(xyz, n_out, valid, start), 5)
        plain_ms = cuda_ms(torch, lambda: t_fps.fps_plain(xyz, n_out, valid, start), 1,
                           warmup=0)
        b_ms, b_by = bound(N * 12 + N * 4 + n_out * 4, 10.0 * N * n_out)
        emit(dict(phase='kernel', name='fps', shape=[N, n_out], agree=ok,
                  max_abs_err=0 if ok else int((s_k != s_p).sum()), ms=ms,
                  plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by))
        if not ok:
            raise AssertionError(f'fps disagrees at {(N, n_out)}')
        if N == 14336:
            rows['fps'] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=None, shape=[N, n_out])

    # K3 / K4 on one decode chunk with the gv1 decoder's attention weights.
    cfg = TrainConfig(**_GV1)
    encoder, decoder, enc_args, dec_args = build_models(cfg)
    wrng = np.random.RandomState(1)
    encoder.load_state_dict(from_jax_params(random_jax_params(encoder, wrng), encoder),
                            strict=True)
    decoder.load_state_dict(from_jax_params(random_jax_params(decoder, wrng), decoder),
                            strict=True)
    enc_args['fps_random_start'] = False
    encoder, decoder = encoder.to(dev).eval(), decoder.to(dev).eval()
    E, D = dec_args['d_latent_local'], dec_args['d_latent']
    pos2 = cloud(531, 10.0)
    feats2 = torch.tensor(rng.randn(1, 531, E).astype(np.float32), device=dev)
    qpos = cloud(_CHUNK, 10.0)
    ki, kd = t_attn.knn_extract(qpos, pos2, 14)
    o_k = t_attn.fused_knn_interp(qpos, pos2, feats2, 8, knn=(ki, kd))
    o_p = t_attn.interp_plain(ki, kd, feats2, 8, 1e-4)
    torch.cuda.synchronize()
    err = float((o_k - o_p).abs().max())
    rel = err / float(o_p.abs().max())
    ok = bool(torch.allclose(o_k, o_p, atol=1e-5, rtol=1e-5))
    ms = cuda_ms(torch, lambda: t_attn.fused_knn_interp(qpos, pos2, feats2, 8,
                                                         knn=(ki, kd)), 20)
    plain_ms = cuda_ms(torch, lambda: t_attn.interp_plain(ki, kd, feats2, 8, 1e-4), 5)
    w = 1.0 / (torch.sqrt(torch.clamp(kd[0, :, :8], min=0.0)) + 1e-4)
    w = (w / w.sum(-1, keepdim=True)).contiguous()
    ki8 = ki[0, :, :8].long().contiguous()
    lib_ms = cuda_ms(torch, lambda: torch.nn.functional.embedding_bag(
        ki8, feats2[0], per_sample_weights=w, mode='sum'), 20)
    b_ms, b_by = bound(_CHUNK * 8 * 8 + 531 * E * 4 + _CHUNK * E * 4,
                       2.0 * _CHUNK * 8 * E)
    emit(dict(phase='kernel', name='interp', shape=[_CHUNK, 531, 8, E], agree=ok,
              max_abs_err=err, max_rel_err=rel, tolerance='atol 1e-5, rtol 1e-5',
              ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
              bound_by=b_by))
    if not ok:
        raise AssertionError(f'interp disagrees: max abs err {err}')
    rows['interp'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=lib_ms, shape=[_CHUNK, 531, 8, E])

    att = decoder.pt_blocks[0].layer2
    params = attention_params(att)
    q_proj = torch.tensor(rng.randn(1, _CHUNK, D).astype(np.float32), device=dev)
    H, P = 2 * D, 32
    for premul in (True, False):
        with torch.no_grad():
            kv = (torch.cat([feats2 @ params['to_k']['kernel'],
                             feats2 @ params['to_v']['kernel']], -1).contiguous()
                  if premul else feats2)
            call = lambda: t_attn._attn_cuda(qpos, q_proj, ki, pos2, kv, params, 14,  # noqa: E731
                                             premul)
            o_k = call()
            o_p = t_attn.attn_plain(qpos, q_proj, ki, pos2, kv, params, 14, premul)
            torch.cuda.synchronize()
            err = float((o_k - o_p).abs().max())
            rel = err / float(o_p.abs().max())
            ok = bool(torch.allclose(o_k, o_p, atol=1e-4, rtol=1e-3))
            ms = cuda_ms(torch, call, 3)
            plain_ms = cuda_ms(torch, lambda: t_attn.attn_plain(
                qpos, q_proj, ki, pos2, kv, params, 14, premul), 2)
        rows_n = _CHUNK * 14
        macs = rows_n * (3 * P + P * D + 2 * D * H + (0 if premul else 2 * E * D))
        nbytes = (_CHUNK * (3 + D) * 4 + _CHUNK * 14 * 4 + 531 * (3 + kv.shape[-1]) * 4
                  + (3 * P + P * D + 2 * D * H + P + 2 * D + H) * 4 + _CHUNK * D * 4)
        # The work is matrix products: its bound is the bf16 tensor-core
        # peak; the f32 CUDA-core figure (what this f32 kernel runs on) is
        # a side field.
        b_ms, b_by = bound(nbytes, 2.0 * macs, _BF16_TC_FLOPS)
        f32_ms = bound(nbytes, 2.0 * macs)[0]
        name = 'attn' if premul else 'attn_per_row'
        emit(dict(phase='kernel', name=name, shape=[_CHUNK, 531, 14, D, E], agree=ok,
                  max_abs_err=err, max_rel_err=rel, tolerance='atol 1e-4, rtol 1e-3',
                  ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                  bound_by=b_by, bound_peak='bf16 tensor core 989 TFLOP/s',
                  bound_f32_cuda_core_ms=f32_ms, flop=2.0 * macs))
        if not ok:
            raise AssertionError(f'{name} disagrees: max abs err {err}')
        if premul:
            rows['attn'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                                bound_peak='bf16 tensor core 989 TFLOP/s',
                                bound_f32_cuda_core_ms=f32_ms,
                                shape=[_CHUNK, 531, 14, D, E])
    del o_k, o_p

    # 4. The main path: encode + dense decode at gv1 width.
    loaded = dict(encoder=encoder, decoder=decoder, device=dev)
    engine = InferenceEngine(loaded, cfg.color_mode, False, cfg.semantic_classes,
                             track_mode='none', implicit_batch_size=_CHUNK)
    pcl = np.random.RandomState(0).rand(14336, 8).astype(np.float32) * 2 - 1
    queries = blind_points_numpy(_NUM_SAMPLE, cfg.min_z, cfg.cr_cube_bounds, 0,
                                 'greater', cfg.cube_mode, 'grid')
    abstract, fg = engine.encode(pcl)          # warm-up run, not counted.
    engine.decode_all(queries[:_CHUNK], abstract, fg, fetch=False)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.time()
    abstract, fg = engine.encode(pcl)
    torch.cuda.synchronize()
    t1 = time.time()
    out = engine.decode_all(queries, abstract, fg, fetch=False)
    torch.cuda.synchronize()
    t2 = time.time()
    counts = _build.launch_counts()
    finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(abstract).all())
    emit(dict(phase='main_path', model='gv1', n_points=14336,
              abstract_shape=list(abstract.shape), global_shape=list(fg.shape),
              queries=int(queries.shape[0]), chunk=_CHUNK, out_shape=list(out.shape),
              finite=finite, encode_ms=(t1 - t0) * 1e3, decode_ms=(t2 - t1) * 1e3,
              scene_ms=(t2 - t0) * 1e3, queries_per_s=queries.shape[0] / (t2 - t1),
              solid_frac=float((out[:, 0] >= 0.5).float().mean()),
              launches=counts, gpu=smi))
    if not finite or list(abstract.shape) != [1, 531, 3 + 288] \
            or list(out.shape) != [queries.shape[0], 5]:
        raise AssertionError('main path output is not finite or has the wrong shape')
    missing = [k for k in _REPLACES if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f'kernels not launched on the main path: {missing}')
    del out

    # 5. Both anchors on the card, against the CPU plain versions.
    for name in ('anchor', 'anchor_carla'):
        path = os.path.join(_HERE, 'tests', 'assets', name, 'checkpoint.pkl')
        res = {}
        for device in ('cuda', 'cpu'):
            L = load_models(path, device=device)
            c = L['train_config']
            seg = c.segmentation_lw > 0
            eng = InferenceEngine(L, c.color_mode, seg, c.semantic_classes,
                                  track_mode='all', implicit_batch_size=_CHUNK)
            r = np.random.RandomState(3)
            n = L['encoder_args']['n_input']
            cl = r.rand(n, 8).astype(np.float32) * 2 - 1
            cl[:, -1] = 0.0
            inst = (r.rand(n) > 0.5).astype(np.int64)
            sem = np.stack([inst, inst, np.full(n, 4)], -1)
            tgt = r.rand(2000, 11).astype(np.float32) * 2 - 1
            res[device] = perform_inference(
                cl, sem, tgt, eng, c.min_z, c.cr_cube_bounds, c.color_mode, 0,
                num_sample=65536, point_sample_mode='grid', predict_segmentation=seg,
                track_mode='all', semantic_classes=c.semantic_classes,
                data_kind=L['data_kind'], cube_mode=c.cube_mode)
        g, cpu = res['cuda']['implicit_output'], res['cpu']['implicit_output']
        err = float(np.abs(g[:, 0] - cpu[:, 0]).max())
        far = np.abs(cpu[:, 0] - 0.5) > 1e-3
        split_ok = bool(np.array_equal((g[:, 0] >= 0.5)[far], (cpu[:, 0] >= 0.5)[far]))
        ok = bool(np.isfinite(g).all()) and err <= 1e-4 and split_ok
        emit(dict(phase='anchor', name=name, queries=int(g.shape[0]),
                  reruns=res['cuda']['phase_s']['track_reruns'],
                  solid=int(len(res['cuda']['output_solid'])),
                  density_max_abs_err_vs_cpu=err, split_agrees=split_ok, ok=ok))
        if not ok:
            raise AssertionError(f'{name}: GPU inference disagrees with the CPU run')

    # 6. Summary lines.
    kernels = []
    for name, src in _SOURCE.items():
        row = dict(name=name, route='cuda', source=f'occlusions4d_torch/csrc/{src}.cu',
                   replaces=_REPLACES[name], launches=int(counts[name]))
        row.update(rows[name])
        kernels.append(row)
    emit(dict(phase='done', seconds=time.time() - t_start))
    print(smi, flush=True)
    emit({'kernels': kernels})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
