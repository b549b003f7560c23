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
     card at the gv1 shapes of its path, with kernel, plain and library times
     (CUDA events); the brute kNN (knn_brute, _KNN_BRUTE_CASES) at the
     encoder's brute searches (B 1 and 3), the decoder's per-chunk search at
     M 531 and 2124 with grid-ordered and random queries and the train
     frames' searches, exact, the wrapper timed (ms) and its C entry on
     prebuilt operands (entry_ms) at the lane count the rule picks and at 16
     and 32 (each result exact), the plain version, cdist + sort, its
     operation bound (8 f32 instructions a pair at the CUDA cores' 33.5 T/s;
     the old 7 FLOP a pair at the FMA rate beside it) and the parent's
     wrapper and entry times from PERF.md (_PARENT_MS, _PARENT_ENTRY_MS);
     the interpolation wrappers and entries (interp, interp_bf16 at the gv1
     chunk with random and grid-ordered queries, interp_g and interp_g_bf16
     at the cv1 chunk) timed the same way, beside the parent's; each
     attention forward line (attn premul and per-row
     at one gv1 decode chunk, premul also at the gv1 train frame, attn_g)
     with its TFLOP/s, its shares of the bf16 and 3xTF32 tensor-core
     bounds, its own peak memory, whether it beats its plain version and
     the parent's time from PERF.md (_PARENT_MS), run twice for the same
     bits; the pruned kNN (preparation included,
     exact against the plain version and the brute kernel, with the
     preparation's time, the brute kernel's, the share of (query tile, key
     block) pairs processed) at the gv1 level-0 self search (14336^2, K 16),
     the sampler's air rejections (3 x 6996 x 28672, K 1, 20% of keys
     masked, candidates jittered from the keys) and the n57344 level-0 self
     search (57344^2, K 16), then the brute/pruned crossover over the main
     paths' searches (knn_crossover); FPS (exact against the plain loop,
     with microseconds per pick and the launch shape of the speed rule) at
     14336 -> 4779, 4779 -> 1593 and 1593 -> 531 at B 1 and 3, 19115 ->
     6372, 200000 -> 2048 (points in device memory) and, for the one-block
     launch, 512 -> 171 at B 3; the backward kernels run at the train
     step's frame (3 examples x 17920 queries; the plain attention backward
     one example at a time; both projection modes; each attention backward
     line with the same rates) and also run twice and must give the same bits (interp_bwd
     also at M 2124 on the index route, and on one real train frame's
     indices in phase 6, its inverse index against a stable argsort, with
     index_add_ timed beside it); the eval labels' direct-difference 1-NN
     (nn1_direct) at CARLA scale (the 541314-query grid against a
     100000-point frame), equal to its plain version; the bidirectional
     1-NN (nn1_bidir) at 28672^2, the wrapper and its C entry on prebuilt
     rows timed (entry_ms), both exact, its bound 8 f32 instructions a
     pair at the CUDA cores' 33.5 T/s (the two fminf not counted); the three
     shared-gather kernels run at one cv1 decode chunk (32768 queries, a
     2124-point abstract cloud), where the per-row index-route attention is
     timed beside gather + attn_g and must give attn_g's bits on the same
     rows; the shared-gather backward kernels
     (scatter, interp_g_bwd, attn_g_bwd) run at one cv1 train frame (3
     examples x 17203 queries against 2124-point abstract clouds; the plain
     attention backward one example at a time), each twice for the same
     bits (interp_g_bwd bit for bit against its plain version, with the
     card's write ceiling for its buffer, dg.zero_() and o4d_fill16,
     and the library call with and without its set-up timed beside it),
     scatter_add_ timed beside the scatter, and the decoder route's
     scatter + interp_bwd of the interpolation's cotangent against its plain
     version; the FPS cluster entry at the n57344 encoder's first level
     (57344 -> 19115, four cases, indices equal to the plain loop's); the
     encoder's fused self-attention (sattn, sattn_bwd) at the four blocks of
     the gv1 train step (B 3) and the n57344 step's first block (B 1), with
     the block's plain chain and the fused route (gather + sattn, backward
     with the scatter) timed beside them; the bf16 compute mode
     (precision='fast') of interp and attn (premul and per-row) at the gv1
     decode chunk and of gather, interp_g and attn_g at the cv1 chunk, each
     against its plain bf16 version on the same inputs (the gather exact,
     the interpolations atol 1e-5 / rtol 1e-5, the attention relative L2
     2e-4 and a largest error of 5e-3 of max |plain|), twice for the same
     bits, timed beside its f32 kernel, with TFLOP/s and the share of the
     bf16 tensor-core bound; the gathered and per-row index routes give the
     same bits in bf16 too; the bf16 backward kernels (the train step's
     fused_decoder_dtype='bf16') beside their f32 lines: attn_bwd_bf16
     (premul and per-row) and interp_bwd_bf16 at the gv1 train frame,
     scatter_bf16 and attn_g_bwd_bf16 at the cv1 train frame, each against
     its plain bf16 version (each gradient within relative L2 5e-3 for the
     attention, 1e-3 for the per-key sums), twice for the
     same bits, its weight-kernel gradients and per-key sums bf16 values,
     the attention's ReLU masks of its last chunk against the plain
     recompute (flips counted), the f32 kernel's distance from the plain
     bf16 version (the gate must reject it), its time beside the f32
     kernel's; attn_g_bwd_bf16 and the per-row index route give the same
     bits for d(q_proj) and the weight gradients; the bf16 mode of the fused
     self-attention (mixed_precision: sattn_bf16, sattn_bwd_bf16) at the
     same five blocks as sattn, against sattn_plain / sattn_bwd_plain in
     bf16 on the same inputs (the forward at the bf16 attention gate, each
     gradient within relative L2 5e-3), the backward twice for the same
     bits, dgf and the weight kernels' gradients bf16 values, the f32
     kernels' distances from the plain bf16 versions (both gates must
     reject them), the times beside the f32 kernels';
  4. main path: gv1 at full width with seeded random weights (numpy, loaded
     through checkpoint.from_jax_params): encode a 14336-point cloud, decode
     the dense grid in chunks of 32768; launch counters are zeroed just before
     and read just after, and every kernel must have launched;
  4b. main_path_cv1: the same for cv1 (layer norm, two abstract levels, 13
     semantic classes) over the CARLA grid: the decoder takes the
     shared-gather route, which must launch gather, interp_g and attn_g and
     neither index-route kernel; one 4096-query chunk is decoded again on the
     CPU (plain versions) from the card's abstract cloud and must agree;
  4c. main_path_fast: the gv1 and cv1 dense scenes again, with the same
     seeded models, cloud and grid, through InferenceEngine(precision=
     'fast'): launch counters zeroed just before and read just after must
     show the bf16 kernels and no f32 interpolation, gather or attention
     launch; the scene time beside the f32 scene's; at most 0.5% of the
     densities across 0.5 against the f32 scene (the share and the largest
     |p - 0.5| among the flips printed);
  5. anchors: both committed checkpoints through load_models and
     perform_inference on the card, against the same run on the CPU (plain
     versions), the ground-truth labels and 1-NN rows (nn1_direct, whose
     launches this path counts) equal query by query; then on the card in
     precision='fast' (bf16 launches, finite), its flip share against the
     f32 run printed;
  5b. eval_driver: the eval driver (occlusions4d_torch.evaluate.test_driver,
     python -m occlusions4d_torch.evaluate) on both committed anchors, each
     scene regenerated from its gen.json by the port's synthetic.py, with
     tests/test_anchor.py's arguments (the committed eval_argv, the frame
     fraction that leaves 3 steps): in f32 (--eval_precision auto) every
     per-frame metric within max(0.02, 3%) of the committed metrics.json and
     the learned-quality floors held (tests/anchor_recipe.py); the GREATER
     anchor pipelined and with --eval_overlap false in the order A B B A (the
     same per-frame values bit for bit; the walls and their ratio printed)
     and through the command line in its own process (its metrics.json the
     same bit for bit); in 'fast' (the first step) the bf16 kernels and no
     f32 decoder kernel launched, each metric's largest delta from the
     committed values printed, not gated; then gv1 at full width (the seeded weights of phase 4, a
     synthetic GREATER scene of 128-pixel images in which every example
     fills the 14336 input points, an eighth of the dense grid (65536
     queries: the host metrics' time scales with them), --save_metrics, 1
     step of 4 frames) through run_test: finite metrics, the index route's
     kernels launched. Each run prints its wall per frame, phase_split_s,
     scene_wall_s, the device_infer share and its launches (per frame too);
     the host plane's build (native.status(), zlib headers) and whether the
     JAX data plane's imaging packages are installed are printed first;
  5c. train_driver: the train driver (occlusions4d_torch.train.main, python
     -m occlusions4d_torch.train) on the gv1 recipe's command line
     (MIGRATION.md:19-31) over a synthetic GREATER dataset with train and
     val stages (_GV1_SCENE's images; every example fills the 14336 input
     points): 2 epochs of 8 train steps and 1 val_aug step, random weights
     from the seed, the launch counters zeroed just before and read just
     after (every kernel of the train step must launch); model_0.pkl,
     model_1.pkl and checkpoint.pkl written; a resume from model_0 re-runs
     epoch 1 and its logged losses equal the unbroken run's within rel 1e-4
     (bit for bit printed); checkpoint.pkl through evaluate.load_models and
     one dense gv1 frame (524288 grid queries), finite; each epoch's wall,
     step count and the spans' host split (train.data / train.h2d /
     train_step / train.guard / train.log_sync / train.viz), the step wall and the loader's share, peak memory; then the
     committed convergence recipe (tests/assets/convergence/
     trajectory.json's argv and scenes, 10 epochs of 19 steps) in f32, with
     --fused_decoder_dtype bf16 and with --mixed_precision true, the three
     at once, each in a process of its own (this script with
     --convergence; its stderr in chiprun_out/): per-epoch
     train and val losses and learning rates printed, the LR drops at
     epochs 4, 6 and 8 and the best of the last 3 val losses below the best
     of the first 3;
  5d. reference_pth: phase eval_driver's gv1 weights (seed 1) written as a
     native .pkl and as a reference .pth (the decoder's first block under
     the legacy pt_block. name, the args Namespace, torch's Adam /
     MultiStepLR / GradScaler state dicts); the .pkl through the eval
     driver in this process (launches counted), the .pth through python -m
     occlusions4d_torch.evaluate in its own at the same time, on the
     synthetic gv1 scene at a sixteenth of the dense grid (32768 queries):
     the per-frame metrics must be equal; then train.main warm-started from the .pth on the gv1
     recipe (3 steps): start epoch, step count (epoch + 1) x steps per
     epoch + the steps run, AdamW's fresh count, finite losses;
  5e. train_batchnorm: the gv1 train step with pt_norm_type 'batch' beside
     'none' from the same seed and batch (1 warm-up + 3 timed steps each,
     one phase-split step, peak memory): finite losses, the running
     statistics moved; a val_aug and a viz step leave them as they were;
     the encoder in eval mode decodes one dense gv1 scene, finite;
  5f. train_loader_workers: a child process (this script with
     --loader-workers) builds the gv1 recipe's loaders with thread and with
     process workers before it touches CUDA, warms the Trainer up for 2
     steps, then times 4-step epochs fed by thread, process, process,
     thread workers: each epoch's step wall, data share and peak memory,
     and each mode's mean;
  5g. train_data_parallel: gv1 at full width, global batch 4 as 2 ranks x 2
     rows on the one card (parallel.spawn over ['cuda:0', 'cuda:0'], gloo:
     NCCL refuses two ranks on one device), every rank on the fixed
     supervision with FPS from point 0, 1 warm-up + 2 timed steps against
     the one-process batch-4 Trainer on the card from the same weights and
     batch, run three times (logged scalars rtol 2e-5, parameter deltas
     1e-4 relative L2, or six times the one-process runs' largest
     distance from each other where that is larger; both ranks' parameters
     equal), each rank's step
     wall, its gradient all-reduce's share of a phase-split step and its
     peak memory beside the one-process step's; one cv1 step of 2 ranks x
     1 row, finite; then train.main over the two ranks (--data_parallel 2's
     path with the device list given, rank 0's loaders on fork workers,
     which refuse a process that has started CUDA) for one epoch of 4
     steps, its checkpoint reloaded through load_models and Trainer.resume (the ranks'
     stdout goes to chiprun_out/train_data_parallel.log);
  5h. eval_query_parallel: the gv1 dense scene (524288 grid queries) with
     InferenceEngine over two replicas on the card against one device at
     the same chunk and at the replicas' per-device chunk, bit for bit (or
     within 1e-5 at the same chunk), in the order one, replicas, one at
     half the chunk, replicas, one, times printed; the committed GREATER
     anchor through the eval driver with the 2-replica engine against the
     one-device driver, per-frame metrics equal;
  6. train: the gv1 train step (Trainer, batch 3, 4 frames, seeded numpy
     weights and a bench.py-shaped synthetic batch): 1 warm-up step, 3 timed
     steps with the launch counters zeroed just before and read just after
     (every kernel of the step must launch, the backward kernels included),
     finite losses, gradients and parameters, changed parameters; then one
     more Trainer.step timed phase by phase through its phase marks
     (encoder, sampler, decoder forward, decoder backward, encoder backward,
     optimizer); the sampler's pruned 1-NN calls per step (the step's
     launches less the encoder's) and their time;
  7. sampler_moving: one gv1-sized sample_frame batch with the 'moving'
     bias, which must launch the bidirectional 1-NN kernel, whose result must
     equal its plain version exactly;
  8. train_cv1: the cv1 train step (Trainer on 'carla', batch 3, 4 frames of
     7168 + 10035 queries, low_moving_ivalo_sembal, seeded numpy weights and
     a CARLA-layout batch as bench.py builds it): 1 warm-up step, 2 timed
     steps with the launch counters zeroed just before and read just after
     (per step gather 4, interp_g 4, attn_g 8, scatter 4, interp_bwd 4,
     attn_g_bwd 8, no interp_g_bwd, no index-route
     attention kernel, and nn1_bidir), finite losses (segmentation included), gradients and
     parameters, changed parameters; one phase-split step; before the
     steps, one decoder forward + backward of a sampled frame's first 1024
     queries on the card and on the CPU (plain versions, same route), loss
     and gradients compared;
  8b. train_bf16: the gv1 and cv1 train steps with fused_decoder_dtype=
     'bf16' beside f32 steps from the same seeded weights, batch and
     generator seed, 5 steps each (the launch counters zeroed after the
     first, read after the last: per step the decoder's bf16 kernels and no
     f32 decoder kernel, the cv1 route's interpolation rows through the f32
     interp_g_bwd into one bf16 scatter; the f32 run no bf16 kernel), finite
     state, every step's loss within 3e-2 of the f32 run's (JAX's own bf16
     gate), the step times side by side;
  9. train_sattn: the gv1 train step with fused_attention='on' (the
     encoder's four PT blocks through gather, sattn, sattn_bwd, scatter):
     first the encoder 'on' against 'auto' on the seeded state (each PT
     block alone, the outputs, every encoder gradient, the DownTransition
     max-pool flips counted), then 1 warm-up + 2 timed steps (launches per
     step checked), finite and changed state, one phase-split step;
  10. train_57k: the n57344 train step (BASELINE.json configs[4]: the gv1
     recipe at 57344 points, batch 1, fused_attention='on'): FPS level 0 on
     the cluster entry, the decoder on the shared-gather route; 1 warm-up +
     2 timed steps (launches per step checked), finite and changed state,
     one phase-split step;
  10b. train_mixed: the gv1 train step with mixed_precision=True (bf16
     networks, AdamW eps 1e-4) with fused_attention 'auto' and 'on' and
     fused_decoder_dtype 'f32' and 'bf16', and the n57344 step with 'on',
     each beside the f32 run from the same seeded state, 2 steps each (the
     launch counters of the mixed steps after the first: per 'on' step
     sattn_bf16, sattn_bwd_bf16, gather_bf16, scatter_bf16 4 each and no
     f32 self-attention kernel, per 'auto' step none of them), finite
     state, each mixed step's loss within 3e-2 of the f32 networks' loss
     from the same state (parameters and generator), both runs' loss
     trajectories printed, one phase-split step each, the step times,
     splits and peak memory side by side;
  11. decoder_wide: decoders wider than one 416-column attention block,
     D 448 (E 320, pt_feat_dim 40) and D 544 (E 288, global_size 256), with
     seeded weights: the engine on one 4096-query chunk against the CPU,
     the first attention layer's forward kernels (attn both modes, attn_g)
     against their plain versions on the chunk's rows, its backward kernels
     (attn_bwd, attn_g_bwd) on the train and cv1 frames their gates were
     set on, and attn_g_bwd on the chunk against float64, held to twice the
     plain version's error there; the same at gv1's D 416 for comparison;
     one Trainer step at D 448 (batch 1, one frame) after a decoder
     gradient check against the CPU; each width's chunk also in
     precision='fast' against the same decode with the plain bf16 versions
     on the card (density 2e-3, relative L2 1e-3);
  12. profile_trace: train.main on the gv1 recipe (one epoch of 5 train
     steps fed by the loader) with --profile_steps 2 --watch_networks true:
     the torch.profiler trace under <log_dir>/profile covers train steps
     1-2 (their train_step_<i> spans) and names o4d_attn, o4d_attn_bwd and
     o4d_knn_brute; its device-busy share over the traced window beside
     PERF.md's host-clock proxies, the top 8 device operations by time with
     their counts and the 3 longest idle gaps; one gradient and one
     parameter norm per parameter tensor, finite; the step wall with and
     without the norms (A B B A, the run's Trainer on a preloaded batch);
  13. train_module_decoder: the gv1 step (batch 3, 4 frames) with
     --fused_decoder off and remat on: from one state and draw the loss and
     the decoder's global gradient norm within 1e-4 relative of the fused
     path's; 1 warm-up + 3 timed steps (no fused decoder kernel launched),
     peak memory, a phase-split step; then the step with remat off, or its
     out-of-memory error;
  14. check_numerics: the gv1 step at batch 1 with --check_numerics: clean
     train, val_aug and viz steps; a NaN pcl_input and a NaN decoder weight
     raise naming pcl_input and decoder_output_frame0; the step's time
     beside the batch-1 step without the flag;
  15. store_activations: the gv1 dense grid through InferenceEngine(
     store_activations=True) in f32 and 'fast': outputs bit-equal to the
     engine's without the flag, (N, 416) float16 activations, finite, in
     query order, the added time; the GREATER anchor's first step through
     the eval driver with and without --store_activations: one float16
     array a frame, one row a predicted-solid query, metrics.json equal;
  16. encoder_up: the gv1 encoder with its up path (enable_decoder,
     skip_connections, 3 UpTransitions, d_out 6) against the same encoder
     with the kNN and FPS entries swapped for their plain versions on the
     card: every index exact, outputs within 1e-5;
each phase followed by a phase_seconds line; then the card's nvidia-smi
line, the {"kernels": [...]} line (each entry
with its launches on the eval_driver phase under "eval_driver", on the
train_driver phase's gv1 run under "train_driver", on rank 0's timed steps
of train_data_parallel, on eval_query_parallel's 2-replica scene and on
phases 12-16 under their names; the five
bf16 forward variants count their launches on main_path_fast, the four bf16
backward ones and interp_g_bwd (the bf16 shared route's interpolation rows)
on train_bf16, the two bf16 self-attention ones on train_mixed; fps, the FPS
kernel's one-block launch, which the speed rule
keeps for clouds of 512 points or fewer, is listed with on_main_path false)
and, last,
{"ok": true, "device": {...}}. Any failed phase exits non-zero. Without CUDA,
or without the package beside this file, it exits non-zero and prints no
result. Imports nothing of JAX.

    python3 chip_smoke.py --phases name[,name...]

runs the environment, build and kernel lines, then only the named phases
(PHASES) and those they need (_PHASE_NEEDS); its {"kernels"} line lists the
rows the run phases launched. An unknown name exits 2. Only the run
without the flag drives every path. To keep that run within its time
budget, train_mixed takes 2 steps a run (5 before), train_loader_workers
4-step epochs (6), train_data_parallel 2 timed steps (3), reference_pth's
eval 32768 queries (131072), eval_driver's gv1 run 65536 queries (131072)
and its 'fast' anchor runs their first step (3); the convergence runs of
train_driver share the time, one process each.
'''

import ctypes
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s, f32 CUDA-core,
# bf16 and TF32 tensor-core FLOP/s.
_HBM_BPS = 3.35e12
_F32_FLOPS = 67e12
_BF16_TC_FLOPS = 989e12
_TF32_TC_FLOPS = 495e12
# f32 instructions per second of the CUDA cores (132 SMs x 128 lanes x 1.98
# GHz): the rate of work that may not fuse into FMAs, such as the kNN's
# separately rounded products and sums and its compares.
_CUDA_CORE_IPS = 33.5e12

# gv1 (bench.py's configuration of the JAX package).
_GV1 = dict(n_points=14336, pt_feat_dim=36, up_down_blocks=3, transition_factor=3,
            pt_num_neighbors=16, down_neighbors=12, global_size=128,
            implicit_mlp_blocks=6, cross_attn_layers=2, cross_attn_neighbors=14,
            cr_attn_type='cc', color_mode='rgb_nosigmoid', tracking_lw=1.0,
            cr_cube_bounds=5.0, min_z=-1.0, num_cr_local_feats=8)
_NUM_SAMPLE = 524288
_CHUNK = 32768
# The gv1 training recipe (MIGRATION.md:19-31): loss weights, sampler, frames.
_GV1_TRAIN = dict(_GV1, color_lw=1.0, density_lw=1.0, segmentation_lw=0.0,
                  point_occupancy_radius=0.2, air_sampling_ratio=1.5,
                  num_cr_solid=7168, past_frames=4, future_frames=0, batch_size=3,
                  point_sample_bias='none')
# cv1 (bench.py:385-393): gv1 with layer norm, two abstract levels (a
# 1593 + 531 = 2124-point abstract cloud, so the decoder takes the
# shared-gather route), 13 semantic classes and the CARLA cuboid.
_CV1 = dict(_GV1, pt_norm_type='layer', segmentation_lw=0.6, color_lw=0.0,
            tracking_lw=0.0, cr_cube_bounds=16.0, cube_mode=4, abstract_levels=2,
            semantic_classes=13)
_CV1_M = 1593 + 531
# The cv1 training recipe (bench.py:385-397): the gv1 recipe with cv1's
# model, loss weights and sampler bias; 7168 solid + 10035 air queries.
_CV1_TRAIN = dict(_GV1_TRAIN, **dict(_CV1, point_sample_bias='low_moving_ivalo_sembal',
                                     air_sampling_ratio=1.4))
_CV1_N = 7168 + int(7168 * 1.4)
# The n57344 scale-out train step (BASELINE.json configs[4], bench.py:366,383):
# the gv1 recipe at 57344 points, batch 1 (pyramid 57344 -> 19115 -> 6372 ->
# 2124: FPS level 0 takes the cluster entry, the decoder the shared gather).
_N57 = dict(_GV1_TRAIN, n_points=57344, batch_size=1)
# Launches per step with fused_attention='on' (4 frames, 2 attention layers
# each; the encoder's four PT blocks gather, attend and scatter once each).
_SATTN_STEP = dict(sattn=4, sattn_bwd=4, gather=4, scatter=4, fps=0, fps_cluster=3,
                   attn=8, interp=4, attn_bwd=8, interp_bwd=4, attn_g=0, interp_g=0,
                   attn_g_bwd=0, interp_g_bwd=0)
# n57344: the encoder's four blocks gather and scatter, the decoder's shared
# route gathers 4 times, scatters 4 times and runs interp_bwd 4 times.
_57K_STEP = dict(sattn=4, sattn_bwd=4, gather=8, scatter=8, fps=0,
                 fps_cluster=3, attn=0, interp=0, attn_bwd=0, interp_bwd=4, attn_g=8,
                 interp_g=4, attn_g_bwd=8, interp_g_bwd=0)
# The encoder's self-attention blocks the sattn kernels are checked at:
# (name, batch, points, index of the PT block in PointEncoder.blocks).
_SATTN_SHAPES = [('gv1_l0', 3, 14336, 0), ('gv1_l1', 3, 4779, 2), ('gv1_l2', 3, 1593, 4),
                 ('gv1_center', 3, 531, 6), ('n57344_l0', 1, 57344, 0)]
# Launches per train step with mixed_precision (phase train_mixed): the
# encoder's four PT blocks through the bf16 gather, sattn_bf16, sattn_bwd_bf16
# and the bf16 scatter with fused_attention='on', none of them with 'auto';
# the f32 self-attention kernels never.
_MIXED_KERNELS = ('sattn_bf16', 'sattn_bwd_bf16', 'gather_bf16', 'scatter_bf16', 'sattn',
                  'sattn_bwd')
_MIXED_STEP = {'on': dict(sattn_bf16=4, sattn_bwd_bf16=4, gather_bf16=4, scatter_bf16=4,
                          sattn=0, sattn_bwd=0),
               'auto': {k: 0 for k in _MIXED_KERNELS}}
# n57344 'on' (the decoder's shared route in f32 adds its own f32 gather and
# scatter, 4 each).
_MIXED_57K_STEP = dict(_MIXED_STEP['on'], gather=4, scatter=4)
_GRAD_CHECK_Q = 1024
# The times PERF.md's kernel tables record for the attention forward lines
# (whose tile the self-attention now shares), the self-attention sums and
# interp_g_bwd before the tile took the encoder's widths, and for the brute
# kNN and the interpolations before their redesign (NVIDIA H100 80GB
# HBM3, 700.00 W); each such line prints its time beside it. Every time is
# the wrapper's (ms); _PARENT_ENTRY_MS holds the C entries' (entry_ms).
_PARENT_MS = {'attn': 19.302, 'attn_per_row': 23.479, 'attn_bf16': 6.514,
              'attn_bf16_per_row': 8.231, 'attn_g': 24.031, 'attn_g_bf16': 8.335,
              'attn_train_frame': 30.195, 'interp_g_bwd': 0.747, 'sattn': 9.80,
              'sattn_bf16': 10.84,
              # The brute kNN and the interpolations before their redesign:
              # the mean of two runs of this script's lines on that tree.
              'knn_brute:enc_4779x14336_k12': 0.9121, 'knn_brute:enc_4779x4779_k16': 0.4476,
              'knn_brute:enc_1593x4779_k12': 0.3712, 'knn_brute:enc_1593x1593_k16': 0.2068,
              'knn_brute:enc_531x1593_k12': 0.1636, 'knn_brute:enc_531x531_k16': 0.0944,
              'knn_brute:enc_531x1593_k12_b3': 0.1664, 'knn_brute:enc_531x531_k16_b3': 0.0971,
              'knn_brute:dec_gv1_chunk_random': 0.1590, 'knn_brute:dec_gv1_chunk_grid': 0.0723,
              'knn_brute:dec_cv1_chunk_random': 0.3159, 'knn_brute:dec_cv1_chunk_grid': 0.1690,
              'knn_brute:dec_gv1_train_frame': 0.2226, 'knn_brute:dec_cv1_train_frame': 0.5110,
              'interp:random': 0.0624, 'interp_bf16:random': 0.0639, 'interp_g': 0.1355,
              'interp_g_bf16': 0.1440}
# The C entries' times on prebuilt operands before the redesign of the brute
# kNN and the interpolations (tools/profile_knn_interp.py on that tree).
_PARENT_ENTRY_MS = {
    'knn_brute:enc_4779x14336_k12': 0.8995, 'knn_brute:enc_4779x4779_k16': 0.4278,
    'knn_brute:enc_1593x4779_k12': 0.3597, 'knn_brute:enc_1593x1593_k16': 0.1956,
    'knn_brute:enc_531x1593_k12': 0.1525, 'knn_brute:enc_531x531_k16': 0.0856,
    'knn_brute:enc_531x1593_k12_b3': 0.1568, 'knn_brute:enc_531x531_k16_b3': 0.0885,
    'knn_brute:dec_gv1_chunk_random': 0.1173, 'knn_brute:dec_gv1_chunk_grid': 0.0625,
    'knn_brute:dec_cv1_chunk_random': 0.3042, 'knn_brute:dec_cv1_chunk_grid': 0.1567,
    'knn_brute:dec_gv1_train_frame': 0.2087, 'knn_brute:dec_cv1_train_frame': 0.5004,
    'interp:random': 0.0564, 'interp_bf16:random': 0.0592, 'interp:grid': 0.0515,
    'interp_bf16:grid': 0.0549, 'interp_g': 0.1325, 'interp_g_bf16': 0.1349}
_CHECK_CHUNK = 4096
_REPLACES = {
    'knn_brute': 'occlusions4d_tpu/ops/pallas_knn.py:88; '
                 'occlusions4d_tpu/ops/pallas_attention.py:1367',
    'knn_pruned': 'occlusions4d_tpu/ops/pallas_knn.py:209',
    'fps': 'occlusions4d_tpu/ops/pallas_fps.py:39',
    'interp': 'occlusions4d_tpu/ops/pallas_attention.py:554',
    'attn': 'occlusions4d_tpu/ops/pallas_attention.py:78',
    'attn_bwd': 'occlusions4d_tpu/ops/pallas_attention.py:246',
    'interp_bwd': 'occlusions4d_tpu/ops/pallas_attention.py:661',
    'nn1_bidir': 'occlusions4d_tpu/ops/pallas_knn.py:521',
    'gather': 'occlusions4d_tpu/ops/pallas_attention.py:814',
    'interp_g': 'occlusions4d_tpu/ops/pallas_attention.py:1254',
    'attn_g': 'occlusions4d_tpu/ops/pallas_attention.py:934',
    'scatter': 'occlusions4d_tpu/ops/pallas_attention.py:837',
    'interp_g_bwd': 'occlusions4d_tpu/ops/pallas_attention.py:1294',
    'attn_g_bwd': 'occlusions4d_tpu/ops/pallas_attention.py:1030',
    'fps_cluster': 'occlusions4d_tpu/ops/pallas_fps.py:39',
    'sattn': 'occlusions4d_tpu/ops/pallas_self_attention.py:56',
    'sattn_bwd': 'occlusions4d_tpu/ops/pallas_self_attention.py:132',
    'nn1_direct': 'occlusions4d_tpu/native/host_ops.cpp:240 (o4d_nn1 behind nn1_host, '
                  'a host op; no Pallas kernel)',
    'interp_bf16': 'occlusions4d_tpu/ops/pallas_attention.py:554 (compute_dtype=bfloat16)',
    'attn_bf16': 'occlusions4d_tpu/ops/pallas_attention.py:78 (compute_dtype=bfloat16)',
    'gather_bf16': 'occlusions4d_tpu/ops/pallas_attention.py:814 (compute_dtype=bfloat16)',
    'interp_g_bf16': 'occlusions4d_tpu/ops/pallas_attention.py:1254 (compute_dtype=bfloat16)',
    'attn_g_bf16': 'occlusions4d_tpu/ops/pallas_attention.py:934 (compute_dtype=bfloat16)',
    'attn_bwd_bf16': 'occlusions4d_tpu/ops/pallas_attention.py:246 (compute_dtype=bfloat16)',
    'attn_g_bwd_bf16': 'occlusions4d_tpu/ops/pallas_attention.py:1030 '
                       '(compute_dtype=bfloat16)',
    'interp_bwd_bf16': 'occlusions4d_tpu/ops/pallas_attention.py:661 '
                       '(compute_dtype=bfloat16)',
    'scatter_bf16': 'occlusions4d_tpu/ops/pallas_attention.py:837 (compute_dtype=bfloat16)',
    'sattn_bf16': 'occlusions4d_tpu/ops/pallas_self_attention.py:56 '
                  '(compute_dtype=bfloat16)',
    'sattn_bwd_bf16': 'occlusions4d_tpu/ops/pallas_self_attention.py:132 '
                      '(compute_dtype=bfloat16)',
}
_SOURCE = {'knn_brute': 'knn', 'knn_pruned': 'knn', 'fps': 'fps', 'interp': 'interp',
           'attn': 'attn', 'attn_bwd': 'attn_bwd', 'interp_bwd': 'interp_bwd',
           'nn1_bidir': 'knn', 'gather': 'gather', 'interp_g': 'interp', 'attn_g': 'attn',
           'scatter': 'gather', 'interp_g_bwd': 'interp', 'attn_g_bwd': 'attn_bwd',
           'fps_cluster': 'fps', 'sattn': 'attn', 'sattn_bwd': 'attn_bwd',
           'nn1_direct': 'knn', 'interp_bf16': 'interp', 'attn_bf16': 'attn',
           'gather_bf16': 'gather', 'interp_g_bf16': 'interp', 'attn_g_bf16': 'attn',
           'attn_bwd_bf16': 'attn_bwd', 'attn_g_bwd_bf16': 'attn_bwd',
           'interp_bwd_bf16': 'interp_bwd', 'scatter_bf16': 'gather', 'sattn_bf16': 'attn',
           'sattn_bwd_bf16': 'attn_bwd'}
# The path whose run gives each kernel's launch count.
_INFER = ('knn_brute', 'knn_pruned', 'fps_cluster', 'interp', 'attn')
_TRAIN = _INFER + ('attn_bwd', 'interp_bwd')
_SHARED = ('gather', 'interp_g', 'attn_g')
# The shared route's backward: the scatter and the attention's; in f32 the
# interpolation's term goes through the index route's interp_bwd, in bf16
# through interp_g_bwd's rows into the one bf16 scatter (train_bf16).
_SHARED_BWD = ('scatter', 'attn_g_bwd')
_PATH = dict({k: 'main_path' for k in _INFER}, attn_bwd='train', interp_bwd='train',
             nn1_bidir='sampler_moving', **{k: 'main_path_cv1' for k in _SHARED},
             **{k: 'train_cv1' for k in _SHARED_BWD}, fps='main_path',
             sattn='train_sattn', sattn_bwd='train_sattn', nn1_direct='anchor',
             **{k: 'main_path_fast' for k in ('interp_bf16', 'attn_bf16', 'gather_bf16',
                                              'interp_g_bf16', 'attn_g_bf16')},
             **{k: 'train_bf16' for k in ('attn_bwd_bf16', 'attn_g_bwd_bf16',
                                          'interp_bwd_bf16', 'scatter_bf16',
                                          'interp_g_bwd')},
             sattn_bf16='train_mixed', sattn_bwd_bf16='train_mixed')
# A kernel entry no main path launches.
_OFF_PATH = {'fps': 'the one-block launch of the FPS kernel: the speed rule '
                    '(csrc/fps.cu o4d_fps_plan) sends clouds of 512 points or '
                    'fewer there, every gv1 / cv1 level to a cluster (fps_cluster); '
                    'the anchors\' 256-point mini-models launch it (eval_driver)'}
# Launches per cv1 train step (4 frames, 2 attention layers each).
_CV1_STEP = dict(gather=4, interp_g=4, attn_g=8, scatter=4, interp_g_bwd=0, attn_g_bwd=8,
                 attn=0, interp=0, attn_bwd=0, interp_bwd=4)
# Launches per train step with fused_decoder_dtype='bf16' (phase train_bf16):
# the decoder's bf16 kernels and none of its f32 ones; on the cv1 route the
# interpolation's row cotangents go through the f32 o4d_interp_g_bwd (the TPU
# kernel has no compute dtype) into the one bf16 scatter.
_F32_DECODER = ('interp', 'attn', 'interp_bwd', 'attn_bwd', 'gather', 'interp_g', 'attn_g',
                'scatter', 'attn_g_bwd')
_BF16_STEP = {
    'gv1': dict(interp_bf16=4, attn_bf16=8, interp_bwd_bf16=4, attn_bwd_bf16=8,
                gather_bf16=0, interp_g_bf16=0, attn_g_bf16=0, attn_g_bwd_bf16=0,
                scatter_bf16=0, interp_g_bwd=0, **{k: 0 for k in _F32_DECODER}),
    'cv1': dict(gather_bf16=4, interp_g_bf16=4, attn_g_bf16=8, attn_g_bwd_bf16=8,
                scatter_bf16=4, interp_g_bwd=4, interp_bf16=0, attn_bf16=0,
                interp_bwd_bf16=0, attn_bwd_bf16=0, **{k: 0 for k in _F32_DECODER})}
_BF16_TRAIN_STEPS = 5          # from one seeded state; the first is the warm-up.
# train_mixed's steps a run (the first the warm-up), cut from 5 to keep the
# whole script within its time budget.
_MIXED_TRAIN_STEPS = 2
_BF16_LOSS_RTOL = 3e-2         # JAX's own bf16 gate (tests/test_pallas_ops.py:141-180).


_T0 = time.time()


def emit(obj):
    """One JSON line; a phase line also carries the seconds since the start."""
    if 'phase' in obj:
        obj = dict(obj, t_s=round(time.time() - _T0, 2))
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


def launch_peak_gib(torch, fn):
    """The device memory one call of fn allocates at its peak beyond what
    was allocated before it (its outputs included), in GiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    del out
    return peak


def attn_rates(flop, ms, b_ms):
    """Achieved rate and shares of an attention kernel's bounds: the bf16
    tensor-core bound, and 3xTF32's (three TF32 products per product)."""
    tf32x3_ms = 3.0 * flop / _TF32_TC_FLOPS * 1e3
    return dict(tflop_s=flop / ms / 1e9, share_of_bound=b_ms / ms,
                bound_3xtf32_ms=tf32x3_ms, share_of_3xtf32_bound=tf32x3_ms / ms)


def rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def bf16_agree(o_k, o_p):
    """The bf16 kernels' gate against their plain bf16 versions: relative L2
    2e-4 and a largest error of 5e-3 of max |plain| (a bf16 operand may
    round to its neighbour where an f32 intermediate moved by an ulp)."""
    return rel_l2(o_k, o_p) <= 2e-4 and max_err(o_k, o_p) <= 5e-3 * float(o_p.abs().max())


_BF16_TOL = 'relative L2 2e-4, max abs err 5e-3 x max|plain|'


# The bf16 backward kernels' gates against their plain bf16 versions:
# relative L2 per gradient. The per-key sums (interp_bwd_bf16, scatter_bf16)
# add at most hundreds of rows: 1e-3. The attention's weight gradients sum
# 250k-720k rows in another order than cuBLAS before their one rounding to
# bf16, so a result may land one bf16 ulp (2^-8 relative) away wherever the
# f32 sums differ in their last bits; 5e-3 allows that on most entries. The
# f32 kernels land outside both (printed on each line).
_SUM_GATE, _ATTN_GATE = 1e-3, 5e-3


def bf16_tol(gate):
    return (f'each gradient relative L2 <= {gate:g} (the logits bias, whose true gradient '
            'is zero: atol 1e-4 x max(1, max|plain|))')


def bf16_grads_each(pairs):
    """{name: relative L2} of (name, kernel, plain) triples."""
    return {'/'.join(n): rel_l2(a, b) for n, a, b in pairs}


def bf16_grads_agree(pairs, gate):
    """The bf16 backward kernels' gate against their plain bf16 versions,
    over (name, kernel, plain) triples: each gradient within relative L2
    `gate` (a ReLU mask may flip where h1 lies within an f32 rounding of
    zero, an f32 intermediate summed in another order may round to the
    neighbouring bf16 operand, a finished sum to the neighbouring bf16
    value), the logits' bias, whose true gradient is zero, within atol
    1e-4 x max(1, max|plain|). :return (ok, worst relative L2, max abs err)."""
    ok, worst, err = True, 0.0, 0.0
    for name, a, b in pairs:
        e = max_err(a, b)
        err = max(err, e)
        if name == ('attn_mlp_2', 'bias') or not bool(b.any()):  # a zero true gradient.
            ok = ok and e <= 1e-4 * max(1.0, float(b.abs().max()))
            continue
        r = rel_l2(a, b)
        worst = max(worst, r)
        ok = ok and r <= gate
    return ok, worst, err


class CaptureWorkspace:
    """Keeps the workspace of the attention backward launches made inside
    (ops/attention.py::_bwd_plan's QC and f32 workspace), whose first buffers
    hold the last chunk's relu(theta_h) and relu(h1) after the launch."""

    def __init__(self, t_attn):
        self.t_attn, self.qc, self.ws = t_attn, None, None

    def __enter__(self):
        self.real = self.t_attn._bwd_plan

        def plan(*a):
            self.qc, self.ws, iws = self.real(*a)
            return self.qc, self.ws, iws
        self.t_attn._bwd_plan = plan
        return self

    def __exit__(self, *exc):
        self.t_attn._bwd_plan = self.real


def mask_flips(torch, t_attn, cap, q_proj, rows_fn, params, K, premul, dims):
    """ReLU masks of the last chunk of the last example that the bf16
    backward kernel recomputed (its workspace, csrc/attn_bwd.cu::carve)
    against the plain bf16 recompute of the same rows
    (attn_bwd_recompute_plain): the entries where relu(h1) > 0 or
    relu(theta_h) > 0 differ, beside the distance of the recomputed hpre
    and relu(h1). rows_fn(b, n0, n1) -> (rel (R, 3), rows (R, C)) as the
    kernel loads them; dims (D, E, H, P) with the kernel's E (premul: D)."""
    D, E, H, P = dims
    B, N = q_proj.shape[:2]
    QC, ws = cap.qc, cap.ws
    n0 = ((N - 1) // QC) * QC
    R, Rmax = (N - n0) * K, QC * K
    off, at = 0, {}
    for nm, width in (('rel', 3), ('f', E), ('ph', P), ('th', D), ('kk', D), ('vv', D),
                      ('hp', D), ('r1', H)):
        at[nm] = (off, width)
        off += (Rmax * width + 3) // 4 * 4

    def buf(nm):
        o, width = at[nm]
        return ws[o:o + R * width].view(R, width)
    rel, x = rows_fn(B - 1, n0, N)
    fw = t_attn.attn_bwd_recompute_plain(q_proj[B - 1, n0:N], rel, x, params, premul, K,
                                         torch.bfloat16)
    return dict(rows=R, h1_flips=int(((buf('r1') > 0) != (fw['r1'] > 0)).sum()),
                h1_entries=R * H, h1_positive=int((fw['r1'] > 0).sum()),
                theta_h_flips=int(((buf('ph') > 0) != (fw['ph'] > 0)).sum()),
                theta_h_entries=R * P, rel_max_abs_diff=max_err(buf('rel'), t_attn.round_bf16(rel)),
                hpre_rel_l2=rel_l2(buf('hp'), fw['hp']), relu_h1_rel_l2=rel_l2(buf('r1'), fw['r1']))


def attn_bwd_bf16_line(torch, t_attn, name, call, plain, f32_call, flip_src, params, K,
                       premul, dims, macs, nbytes, shape, f32_ms, same_as=None):
    """One bf16 attention backward kernel line: call() -> (d(q_proj), d(rows),
    {leaf: d(weight)}) against plain() (its plain bf16 version) at
    bf16_grads_agree's gate, twice for the same bits, the weight kernels'
    gradients and (index route) d(kv) bf16 values, the ReLU masks of its
    last chunk against the plain recompute (mask_flips), the f32 kernel's
    distance from the plain bf16 version (f32_call; the gate must reject
    it), its time beside the f32 kernel's (f32_ms) and the plain version's.
    same_as: (d(q_proj), weight grads) of another route on the same rows,
    which must be bit-equal. flip_src: (q_proj, rows_fn) of mask_flips.
    Returns the {"kernels"} row and the kernel's d(q_proj) and weight
    gradients."""
    with torch.no_grad(), CaptureWorkspace(t_attn) as cap:
        dq, dx, dw = call()
        torch.cuda.synchronize()
        flips = mask_flips(torch, t_attn, cap, flip_src[0], flip_src[1], params, K, premul,
                           dims)
    with torch.no_grad():
        dq2, dx2, dw2 = call()
        rq, rx, rw = plain()
    torch.cuda.synchronize()
    names = [('q_proj',), ('rows',)] + sorted(rw)
    triples = list(zip(names, [dq, dx] + [dw[n] for n in sorted(rw)],
                       [rq, rx] + [rw[n] for n in sorted(rw)]))
    ok, worst, err = bf16_grads_agree(triples, _ATTN_GATE)
    each = bf16_grads_each(triples)
    del triples
    repro = max([max_err(dq, dq2), max_err(dx, dx2)] + [max_err(dw[n], dw2[n]) for n in dw])
    kernels_bf16 = all(bool(torch.equal(dw[n], t_attn.round_bf16(dw[n]))) for n in dw
                       if n[1] == 'kernel')
    same = None
    if same_as is not None:
        same = bool(torch.equal(dq, same_as[0])) and all(
            bool(torch.equal(dw[n], same_as[1][n])) for n in same_as[1])
    del dq2, dx2, dw2
    with torch.no_grad():
        fq, fx, fw = f32_call()
    f_ok, f_worst, _ = bf16_grads_agree(list(zip(names, [fq, fx] + [fw[n] for n in sorted(rw)],
                                                 [rq, rx] + [rw[n] for n in sorted(rw)])),
                                        _ATTN_GATE)
    del fq, fx, fw, rq, rx, rw
    with torch.no_grad():
        ms = cuda_ms(torch, call, 3)
        peak = launch_peak_gib(torch, call)
        plain_ms = cuda_ms(torch, plain, 1)
    b_ms, b_by = bound(nbytes, 2.0 * macs, _BF16_TC_FLOPS)
    rates = attn_rates(2.0 * macs, ms, b_ms)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None, bound_peak='bf16 tensor core 989 TFLOP/s', shape=shape,
               rel_l2_err=worst, rel_l2_each=each, repeat_max_abs_diff=repro,
               f32_kernel_ms=f32_ms,
               speedup_vs_f32=f32_ms / ms, mask_flips=flips, launch_peak_gib=peak,
               f32_kernel_rel_l2_vs_plain=f_worst, f32_kernel_within_gate=f_ok, **rates)
    good = ok and repro == 0.0 and kernels_bf16 and not f_ok and same is not False
    emit(dict(phase='kernel', name=name, agree=good, tolerance=bf16_tol(_ATTN_GATE),
              weight_kernel_grads_are_bf16=kernels_bf16, same_bits_as_other_route=same,
              plain='attn_bwd_plain / attn_g_bwd_plain in bf16 (attn_bwd_rows_plain, one '
                    'example at a time inside)',
              flop=2.0 * macs, **row))
    if not good:
        raise AssertionError(f'{name} disagrees (worst rel L2 {worst}), is not reproducible '
                             f'({repro}), its weight gradients are not bf16 '
                             f'({kernels_bf16}), its route differs ({same}), or the f32 '
                             f'kernel passes its gate ({f_worst})')
    return row, dq, dw


def bf16_sum_line(torch, name, call, plain, f32_call, library, library_what, b_ms, b_by,
                  shape):
    """A bf16 per-key-sum kernel (interp_bwd_bf16, scatter_bf16) against
    its plain bf16 version at bf16_grads_agree's gate, twice for the same
    bits, its output bf16 values, the f32 kernel's distance (rejected by the
    gate), its time beside the f32 kernel's, the plain version's and the
    library call's; emits the kernel line and returns its row."""
    o_k, o_2, o_p, o_f = call(), call(), plain(), f32_call()
    torch.cuda.synchronize()
    ok, rel, err = bf16_grads_agree([(name, o_k, o_p)], _SUM_GATE)
    f_ok, f_rel, _ = bf16_grads_agree([(name, o_f, o_p)], _SUM_GATE)
    repro = max_err(o_k, o_2)
    is_bf16 = bool(torch.equal(o_k, o_k.to(torch.bfloat16).float()))
    del o_k, o_2, o_p, o_f
    ms = cuda_ms(torch, call, 20)
    f32_ms = cuda_ms(torch, f32_call, 20)
    plain_ms = cuda_ms(torch, plain, 5)
    lib_ms = cuda_ms(torch, library, 20)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib_ms, shape=shape, rel_l2_err=rel, repeat_max_abs_diff=repro,
               f32_kernel_ms=f32_ms, f32_kernel_rel_l2_vs_plain=f_rel,
               f32_kernel_within_gate=f_ok, share_of_bound=b_ms / ms)
    good = ok and repro == 0.0 and is_bf16 and not f_ok
    emit(dict(phase='kernel', name=name, agree=good, tolerance=bf16_tol(_SUM_GATE),
              output_is_bf16=is_bf16, library=library_what, **row))
    if not good:
        raise AssertionError(f'{name} disagrees (rel L2 {rel}), is not reproducible '
                             f'({repro}), is not bf16 ({is_bf16}) or the f32 kernel passes '
                             f'its gate ({f_rel})')
    return row


def attn_fwd_line(torch, name, call, plain, macs, nbytes, shape, reps=3, bf16=False,
                  f32_call=None, **extra):
    """One attention forward kernel line: the kernel against its plain
    version (atol 1e-4, rtol 1e-3; bf16: bf16_agree), twice for the same
    bits, its time, its plain version's, its launch peak, TFLOP/s and its
    shares of the bf16 and 3xTF32 tensor-core bounds. f32_call (bf16 lines):
    the f32 tile on the same inputs, whose distance from the plain bf16
    version is printed beside the kernel's (how far a tile that skips the
    bf16 roundings lands from the gate). Returns (the {"kernels"} row, the
    kernel's output)."""
    with torch.no_grad():
        o_k, o_2 = call(), call()
        o_p = plain()
        torch.cuda.synchronize()
        err = max_err(o_k, o_p)
        rel = err / float(o_p.abs().max())
        l2 = rel_l2(o_k, o_p)
        ok = bf16_agree(o_k, o_p) if bf16 else bool(torch.allclose(o_k, o_p, atol=1e-4,
                                                                    rtol=1e-3))
        repro = max_err(o_k, o_2)
        del o_2
        if f32_call is not None:
            o_f = f32_call()
            extra = dict(extra, f32_tile_rel_l2_vs_plain=rel_l2(o_f, o_p),
                         f32_tile_max_rel_err_vs_plain=max_err(o_f, o_p) / float(
                             o_p.abs().max()),
                         f32_tile_within_gate=bf16_agree(o_f, o_p))
            del o_f
        del o_p
        ms = cuda_ms(torch, call, reps)
        plain_ms = cuda_ms(torch, plain, 2)
        peak = launch_peak_gib(torch, call)
    b_ms, b_by = bound(nbytes, 2.0 * macs, _BF16_TC_FLOPS)
    f32_ms = bound(nbytes, 2.0 * macs)[0]
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None, bound_peak='bf16 tensor core 989 TFLOP/s',
               bound_f32_cuda_core_ms=f32_ms, shape=shape, repeat_max_abs_diff=repro,
               launch_peak_gib=peak, beats_plain=ms < plain_ms,
               **attn_rates(2.0 * macs, ms, b_ms))
    emit(dict(phase='kernel', name=name, agree=ok, max_rel_err=rel, rel_l2_err=l2,
              tolerance=_BF16_TOL if bf16 else 'atol 1e-4, rtol 1e-3', flop=2.0 * macs,
              parent_ms_perf_md=_PARENT_MS.get(name), **row, **extra))
    if not ok or repro != 0.0:
        raise AssertionError(f'{name} disagrees (max abs err {err}) or is not '
                             f'reproducible ({repro})')
    return row, o_k


def attn_fwd_work(rows_n, n_q, m_keys, kv_w, D, E, H, P, per_row):
    """(multiply-adds, bytes) of the attention forward over rows_n rows of
    n_q queries: theta, gamma and, per row, k and v; each input read once
    (queries, indices or gathered rows, keys, weights), the output written
    once."""
    extra = 2 * E * D if per_row else 0
    macs = rows_n * (3 * P + P * D + 2 * D * H + extra)
    n_w = 3 * P + P * D + 2 * D * H + P + 2 * D + H + extra
    nbytes = 4 * (n_q * (3 + D) + m_keys * kv_w + n_w + n_q * D)
    return macs, nbytes


def interp_bf16_line(torch, name, call, plain, library, library_what, b_ms, b_by, shape,
                     f32_ms, flop, entry, parent=None, parent_entry=None):
    """An interpolation kernel's bf16 mode against its plain bf16 version
    (atol 1e-5, rtol 1e-5, the f32 gate: exact bf16 products), twice for the
    same bits, its wrapper's time (ms) and its C entry's (entry(): entry_ms)
    beside the f32 kernel's, the plain version's, the library call's and the
    parent's from PERF.md (wrapper and entry); emits the kernel line and
    returns its row."""
    o_k, o_2, o_p = call(), call(), plain()
    torch.cuda.synchronize()
    err = max_err(o_k, o_p)
    ok = bool(torch.allclose(o_k, o_p, atol=1e-5, rtol=1e-5))
    repro = max_err(o_k, o_2)
    ms = cuda_ms(torch, call, 20)
    e_ms = entry()
    plain_ms = cuda_ms(torch, plain, 5)
    lib_ms = cuda_ms(torch, library, 20)
    row = dict(max_abs_err=err, ms=ms, entry_ms=e_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib_ms, shape=shape, share_of_bound=b_ms / ms,
               entry_share_of_bound=b_ms / e_ms, tflop_s=flop / ms / 1e9, f32_kernel_ms=f32_ms,
               repeat_max_abs_diff=repro)
    emit(dict(phase='kernel', name=name, agree=ok, tolerance='atol 1e-5, rtol 1e-5',
              rel_l2_err=rel_l2(o_k, o_p), library=library_what, parent_ms_perf_md=parent,
              parent_entry_ms_perf_md=parent_entry, **row))
    if not ok or repro != 0.0:
        raise AssertionError(f'{name} disagrees (max abs err {err}) or is not '
                             f'reproducible ({repro})')
    return row


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


def max_err(a, b):
    return float((a - b).detach().abs().max())


def plain_per_example(torch, fn, args):
    """A plain attention backward one example at a time (its autograd graph
    for the whole batch would hold tens of GB): every tensor argument is
    sliced to one example; the weight gradients of the examples add up, the
    other two results stack."""
    parts = [fn(*[a[b:b + 1] if isinstance(a, torch.Tensor) else a for a in args])
             for b in range(args[1].shape[0])]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
            {n: sum(p[2][n] for p in parts) for n in parts[0][2]})


def interp_bwd_line(torch, t_attn, dev, ki, kd, gi, M, KI, case):
    """interp_bwd at one input: against its plain version, twice for the
    same bits, its inverse index against a stable argsort, its time beside
    the plain version's and index_add_'s, and the bound; emits a kernel line
    and returns its numbers."""
    B, N, E = gi.shape
    d1, perm, offsets = t_attn._interp_bwd_launch(ki, kd, gi, M, KI, 1e-4)
    d2 = t_attn.interp_bwd(ki, kd, gi, M, KI, 1e-4)
    ref = t_attn.interp_bwd_plain(ki, kd, gi, M, KI, 1e-4)
    keys = (ki[..., :KI].long() + M * torch.arange(B, device=dev).view(B, 1, 1)).reshape(-1)
    torch.cuda.synchronize()
    index_ok = bool(torch.equal(perm.long(), torch.argsort(keys, stable=True)))
    runs = torch.diff(offsets)
    err, repro = max_err(d1, ref), max_err(d1, d2)
    ok = bool(torch.allclose(d1, ref, atol=1e-4 * max(1.0, float(ref.abs().max())),
                             rtol=1e-3)) and index_ok
    del d1, d2, perm, offsets
    ms = cuda_ms(torch, lambda: t_attn.interp_bwd(ki, kd, gi, M, KI, 1e-4), 20)
    plain_ms = cuda_ms(torch, lambda: t_attn.interp_bwd_plain(ki, kd, gi, M, KI, 1e-4), 5)
    # Library: index_add_ of the weighted rows into the (B * M, E) stack
    # (the weighting is not timed).
    w = 1.0 / (torch.sqrt(torch.clamp(kd[..., :KI], min=0.0)) + 1e-4)
    wrows = ((w / w.sum(-1, keepdim=True))[..., None] * gi[:, :, None, :]).reshape(-1, E)
    lib_ms = cuda_ms(torch, lambda: torch.zeros((B * M, E), device=dev).index_add_(
        0, keys, wrows), 20)
    del wrows
    b_ms, b_by = bound(B * (N * KI * 8 + N * E * 4 + M * E * 4), 2.0 * B * N * KI * E)
    shape = [B, N, M, KI, E]
    line = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, shape=shape, repeat_max_abs_diff=repro,
                longest_run=int(runs.max()), mean_run=float(runs.float().mean()))
    emit(dict(phase='kernel', name='interp_bwd', case=case, agree=ok,
              index_equals_stable_argsort=index_ok,
              tolerance='atol 1e-4 x max(1, max|plain|), rtol 1e-3',
              library='index_add_ of the weighted rows', **line))
    if not ok or repro != 0.0:
        raise AssertionError(f'interp_bwd ({case}) disagrees (err {err}, index '
                             f'{index_ok}) or is not reproducible ({repro})')
    return line


def gt_per_query(res):
    """[label | 1-NN target row] of every query of a perform_inference
    result, in query order (its solid/air split undone)."""
    solid = res['implicit_output'][:, 0] >= 0.5
    gt = np.empty((len(solid), res['gt_solid'].shape[1]), res['gt_solid'].dtype)
    gt[solid], gt[~solid] = res['gt_solid'], res['gt_air']
    return gt


def nn1_direct_line(torch, t_knn, dev, query, keys, case, radius=0.2):
    """nn1_direct at one (query, keys) pair of numpy clouds: distances and
    indices equal to the plain version on the card, its time, the plain
    version's, the bound, and how many labels (d < radius) the kNN
    operator's expansion would flip; emits a kernel line and returns its
    numbers."""
    q = torch.tensor(np.asarray(query, np.float32)[:, :3], device=dev)
    k = torch.tensor(np.asarray(keys, np.float32)[:, :3], device=dev)
    N, M = q.shape[0], k.shape[0]
    d, i = t_knn.nn1_direct(q, k)
    pd, pi = t_knn.nn1_direct_plain(q, k)
    kd, _ = t_knn.knn(q[None], k[None], 1)
    torch.cuda.synchronize()
    exact = bool(torch.equal(d, pd)) and bool(torch.equal(i, pi))
    flips = int(((kd[0, :, 0] < radius) != (d < radius)).sum())
    err = max_err(d, pd)
    del pd, pi, kd
    ms = cuda_ms(torch, lambda: t_knn.nn1_direct(q, k), 3)
    plain_ms = cuda_ms(torch, lambda: t_knn.nn1_direct_plain(q, k), 1, warmup=0)
    # Per pair: 3 subtractions, 3 products, 2 sums (the compare not counted).
    b_ms, b_by = bound(N * 12 + M * 12 + N * 8, 8.0 * N * M)
    line = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by, shape=[N, M])
    emit(dict(phase='kernel', name='nn1_direct', case=case, agree=exact, exact=exact,
              tolerance='exact (bit-equal distances and indices)',
              solid_labels=int((d < radius).sum()), knn_expansion_label_flips=flips,
              library='none: one PyTorch call (cdist) would hold the N x M matrix',
              **line))
    if not exact:
        raise AssertionError(f'nn1_direct ({case}) differs from its plain version')
    return line


def check_backward_kernels(torch, t_attn, t_knn, dev, rng, params, E, rows):
    """The attention forward (premul) and kernels A (both modes) and B at
    the train step's frame (3 examples of 17920 queries, each against its
    own 531-point abstract cloud), kernel C at 28672^2, each against its
    plain version (A per example); the forward, A and B also run twice for
    reproducibility."""
    B, N, M, K, KI = 3, 17920, 531, 14, 8
    D = params['attn_mlp_0']['kernel'].shape[0]
    H, P = params['attn_mlp_0']['kernel'].shape[1], params['pos_mlp_0']['kernel'].shape[1]

    def rand(*shape, scale=None):
        a = rng.rand(*shape) * scale - scale / 2 if scale else rng.randn(*shape)
        return torch.tensor(a.astype(np.float32), device=dev)
    pos2, feats2 = rand(B, M, 3, scale=10.0), rand(B, M, E)
    qpos = rand(B, N, 3, scale=10.0)
    ki, kd = t_attn.knn_extract(qpos, pos2, K)
    q_proj, g = rand(B, N, D), rand(B, N, D)
    for premul in (True, False):
        with torch.no_grad():
            kv = (torch.cat([feats2 @ params['to_k']['kernel'],
                             feats2 @ params['to_v']['kernel']], -1).contiguous()
                  if premul else feats2)
            args = (qpos, q_proj, ki, pos2, kv, params, K, premul, g)
        if premul:
            # The forward at the train step's frame, where a gv1 step launches
            # it 8 times.
            macs_f, nbytes_f = attn_fwd_work(B * N * K, B * N, B * M, 3 + kv.shape[-1], D, E,
                                             H, P, False)
            rows['attn']['train_frame'], _ = attn_fwd_line(
                torch, 'attn_train_frame', lambda: t_attn._attn_cuda(*args[:-1]),
                lambda: t_attn.attn_plain(*args[:-1]), macs_f, nbytes_f + B * N * K * 4,
                [B, N, M, K, D, E])
        with torch.no_grad():
            dq, dkv, dw = t_attn.attn_bwd(*args)
            dq2, dkv2, dw2 = t_attn.attn_bwd(*args)
        rq, rkv, rw = plain_per_example(torch, t_attn.attn_bwd_plain, args)
        torch.cuda.synchronize()
        pairs = [(dq, rq), (dkv, rkv)] + [(dw[n], rw[n]) for n in sorted(rw)]
        err = max(max_err(a, b) for a, b in pairs)
        # Each gradient's error over its own scale max(1, max|plain|), the
        # tolerance's yardstick (attn_mlp_2's bias has an exactly-zero true
        # gradient, so a plain relative error means nothing there).
        scaled = max(max_err(a, b) / max(1.0, float(b.abs().max())) for a, b in pairs)
        ok = all(bool(torch.allclose(a, b, atol=1e-4 * max(1.0, float(b.abs().max())),
                                     rtol=1e-3)) for a, b in pairs)
        repro = max([max_err(dq, dq2), max_err(dkv, dkv2)]
                    + [max_err(dw[n], dw2[n]) for n in dw])
        with torch.no_grad():
            ms = cuda_ms(torch, lambda: t_attn.attn_bwd(*args), 3)
            peak = launch_peak_gib(torch, lambda: t_attn.attn_bwd(*args))
        plain_ms = cuda_ms(torch, lambda: plain_per_example(torch, t_attn.attn_bwd_plain, args), 2)
        CW = kv.shape[-1]
        extra = 0 if premul else E * D
        # Per row: the recomputed forward and the backward products.
        macs = B * N * K * ((3 * P + P * D + 2 * D * H + 2 * extra)
                            + (4 * D * H + 2 * P * D + 3 * P + 4 * extra))
        n_w = 3 * P + P + P * D + D + D * H + H + H * D + D + 2 * extra
        nbytes = 4 * (B * N * (3 + D + K + D + D) + 2 * B * M * CW + B * M * 3 + 2 * n_w)
        b_ms, b_by = bound(nbytes, 2.0 * macs, _BF16_TC_FLOPS)
        f32_ms = bound(nbytes, 2.0 * macs)[0]
        rates = attn_rates(2.0 * macs, ms, b_ms)
        name = 'attn_bwd' if premul else 'attn_bwd_per_row'
        shape = [B, N, M, K, D, E]
        emit(dict(phase='kernel', name=name, shape=shape, agree=ok,
                  max_abs_err=err, max_scaled_err=scaled,
                  tolerance='atol 1e-4 x max(1, max|plain|), rtol 1e-3',
                  repeat_max_abs_diff=repro, ms=ms, plain_ms=plain_ms,
                  plain='autograd through attn_plain, one example at a time',
                  library_ms=None, bound_ms=b_ms, bound_by=b_by,
                  bound_peak='bf16 tensor core 989 TFLOP/s',
                  bound_f32_cuda_core_ms=f32_ms, flop=2.0 * macs, launch_peak_gib=peak,
                  **rates))
        if not ok or repro != 0.0:
            raise AssertionError(f'{name} disagrees (err {err}) or is not reproducible '
                                 f'({repro})')
        if premul:
            rows['attn_bwd'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                                    bound_peak='bf16 tensor core 989 TFLOP/s',
                                    bound_f32_cuda_core_ms=f32_ms, shape=shape,
                                    repeat_max_abs_diff=repro, launch_peak_gib=peak,
                                    **rates)
        else:
            rows['attn_bwd']['per_row'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                               bound_ms=b_ms, bound_f32_cuda_core_ms=f32_ms,
                                               launch_peak_gib=peak, **rates)
        del dq, dkv, dw, dq2, dkv2, dw2, rq, rkv, rw
        # The bf16 mode (fused_decoder_dtype='bf16') on the same inputs.

        def index_rows(b, n0, n1, kv=kv):
            idx = ki[b, n0:n1, :K].long().reshape(-1)
            rel = qpos[b, n0:n1, None, :].expand(-1, K, -1).reshape(-1, 3) \
                - t_attn.round_bf16(pos2[b][idx])
            return rel, t_attn.round_bf16(kv[b][idx])
        bf_row, _, _ = attn_bwd_bf16_line(
            torch, t_attn, name.replace('attn_bwd', 'attn_bwd_bf16'),
            lambda: t_attn.attn_bwd(*args, torch.bfloat16),
            lambda: t_attn.attn_bwd_plain(*args, torch.bfloat16),
            lambda: t_attn.attn_bwd(*args), (q_proj, index_rows), params, K, premul,
            (D, D if premul else E, H, P), macs, nbytes, shape, ms)
        if premul:
            rows['attn_bwd_bf16'] = bf_row
        else:
            rows['attn_bwd_bf16']['per_row'] = bf_row

    gi = rand(B, N, E)
    rows['interp_bwd'] = interp_bwd_line(torch, t_attn, dev, ki, kd, gi, M, KI,
                                         'gv1_train_frame')
    # Its bf16 mode on the same inputs; library: index_add_ of the rounded
    # weighted rows (the weighting and rounding not timed).
    bf = torch.bfloat16
    w = 1.0 / (torch.sqrt(torch.clamp(kd[..., :KI], min=0.0)) + 1e-4)
    wrows = t_attn.round_bf16(((w / w.sum(-1, keepdim=True))[..., None]
                               * gi[:, :, None, :]).reshape(-1, E))
    keys = (ki[..., :KI].long() + M * torch.arange(B, device=dev).view(B, 1, 1)).reshape(-1)
    rows['interp_bwd_bf16'] = bf16_sum_line(
        torch, 'interp_bwd_bf16', lambda: t_attn.interp_bwd(ki, kd, gi, M, KI, 1e-4, bf),
        lambda: t_attn.interp_bwd_plain(ki, kd, gi, M, KI, 1e-4, bf),
        lambda: t_attn.interp_bwd(ki, kd, gi, M, KI, 1e-4),
        lambda: torch.zeros((B * M, E), device=dev).index_add_(0, keys, wrows),
        'index_add_ of the bf16-rounded weighted rows', rows['interp_bwd']['bound_ms'],
        rows['interp_bwd']['bound_by'], [B, N, M, KI, E])
    del wrows, keys
    # M 2124 on the index route (above the old shared-memory cap of 1816).
    pos2b = rand(B, _CV1_M, 3, scale=10.0)
    kib, kdb = t_attn.knn_extract(qpos, pos2b, K)
    rows['interp_bwd']['m2124'] = interp_bwd_line(torch, t_attn, dev, kib, kdb, gi,
                                                  _CV1_M, KI, 'm2124_index_route')
    del pos2b, kib, kdb

    NC = 28672
    a = torch.tensor(rng.rand(1, NC, 3).astype(np.float32) * 10.0 - 5.0, device=dev)
    b = torch.tensor(rng.rand(1, NC, 3).astype(np.float32) * 10.0 - 5.0, device=dev)
    inf = float('inf')
    an = torch.where(torch.tensor(rng.rand(1, NC) > 0.05, device=dev), t_knn.sq_norm(a),
                     torch.full((1, NC), inf, device=dev))
    bn = torch.where(torch.tensor(rng.rand(1, NC) > 0.05, device=dev), t_knn.sq_norm(b),
                     torch.full((1, NC), inf, device=dev))
    ka, kb = t_knn.nn1_bidir_rank(a, an, b, bn)
    pa, pb = t_knn.nn1_bidir_plain(a, an, b, bn)
    torch.cuda.synchronize()
    ok = bool(torch.equal(ka, pa)) and bool(torch.equal(kb, pb))
    fin = torch.isfinite(pa)
    err = max(max_err(ka[fin], pa[fin]), max_err(kb[torch.isfinite(pb)],
                                                  pb[torch.isfinite(pb)]))
    ms = cuda_ms(torch, lambda: t_knn.nn1_bidir_rank(a, an, b, bn), 10)
    # The C entry alone on prebuilt (x, y, z, |p|^2) rows (its outputs only
    # take minima, so repeated launches into them time the same work).
    a4, b4 = (torch.cat([p, pn[..., None]], -1).contiguous() for p, pn in ((a, an), (b, bn)))
    out_a, out_b = torch.full_like(an, inf), torch.full_like(bn, inf)
    from occlusions4d_torch.ops import _build
    e_ms = entry_ms(torch, _build.library('knn'), 'o4d_nn1_bidir',
                    [a4, b4, out_a, out_b, 1, NC, NC], 10)
    torch.cuda.synchronize()
    e_ok = bool(torch.equal(out_a, pa)) and bool(torch.equal(out_b, pb))
    del a4, b4, out_a, out_b
    plain_ms = cuda_ms(torch, lambda: t_knn.nn1_bidir_plain(a, an, b, bn), 2)

    def lib():
        d = torch.cdist(a, b)
        return d.amin(-1), d.amin(-2)
    lib_ms = cuda_ms(torch, lib, 3)
    # Per pair 8 f32 instructions under -fmad=false (3 mul + 2 add for the
    # dot, the doubling, 2 sub) at the CUDA cores' instruction rate; the two
    # fminf a pair are not counted. The old figure, 8 FLOP at the FMA rate,
    # beside it.
    b_ms, b_by = bound((2 * NC) * 16 + (2 * NC) * 4, 8.0 * NC * NC, _CUDA_CORE_IPS)
    emit(dict(phase='kernel', name='nn1_bidir', shape=[NC, NC], agree=ok and e_ok,
              exact=ok and e_ok, max_abs_err=err, tolerance='exact (bit-equal)', ms=ms,
              entry_ms=e_ms, entry_exact=e_ok, share_of_bound=b_ms / ms,
              entry_share_of_bound=b_ms / e_ms, plain_ms=plain_ms, library_ms=lib_ms,
              library='torch.cdist + amin along both axes', bound_ms=b_ms, bound_by=b_by,
              bound_fma_rate_ms=8.0 * NC * NC / _F32_FLOPS * 1e3,
              bound_counts='8 f32 instructions a pair, the 2 fminf not counted'))
    if not (ok and e_ok):
        raise AssertionError(f'nn1_bidir differs from its plain version (err {err}, '
                             f'entry exact {e_ok})')
    rows['nn1_bidir'] = dict(max_abs_err=err, ms=ms, entry_ms=e_ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, shape=[NC, NC])


def seeded_models(torch, cfg, dev, seed):
    """Encoder and decoder of `cfg` with seeded random weights, on `dev`."""
    from occlusions4d_torch.checkpoint import from_jax_params
    from occlusions4d_torch.models import build_models
    encoder, decoder, _, dec_args = build_models(cfg)
    wrng = np.random.RandomState(seed)
    encoder.load_state_dict(from_jax_params(random_jax_params(encoder, wrng), encoder),
                            strict=True)
    decoder.load_state_dict(from_jax_params(random_jax_params(decoder, wrng), decoder),
                            strict=True)
    encoder.fps_random_start = False
    return encoder.to(dev).eval(), decoder.to(dev).eval(), dec_args


def check_shared_gather_kernels(torch, t_attn, dev, rng, params, E, rows):
    """gather, interp_g and attn_g at one cv1 decode chunk (32768 queries
    against a 2124-point abstract cloud; K 14 gathered, interpolation over
    8), each against its plain version; the index-route attention (per-row
    and premul) and interpolation kernels run on the same neighbours for the
    comparison of the two routes."""
    N, M, K, KI, C = _CHUNK, _CV1_M, 14, 8, E + 3
    D = params['attn_mlp_0']['kernel'].shape[0]
    H, P = params['attn_mlp_0']['kernel'].shape[1], params['pos_mlp_0']['kernel'].shape[1]

    def cloud(n):
        return torch.tensor(rng.rand(1, n, 3).astype(np.float32) * 10.0 - 5.0, device=dev)
    pos2, qpos = cloud(M), cloud(N)
    feats2 = torch.tensor(rng.randn(1, M, E).astype(np.float32), device=dev)
    q_proj = torch.tensor(rng.randn(1, N, D).astype(np.float32), device=dev)
    knn = t_attn.knn_extract(qpos, pos2, K)
    ki, kd = knn
    fv = torch.cat([feats2, pos2], -1).contiguous()

    # The gather: a copy, bit-equal.
    gather = lambda: t_attn.knn_gather_rows(pos2, feats2, knn, K)  # noqa: E731
    g = gather()
    g_p = t_attn.gather_rows_plain(fv, ki, K)
    torch.cuda.synchronize()
    exact = bool(torch.equal(g, g_p))
    err = max_err(g, g_p)
    ms = cuda_ms(torch, gather, 20)
    plain_ms = cuda_ms(torch, lambda: t_attn.gather_rows_plain(fv, ki, K), 5)
    flat = ki[..., :K].long().transpose(1, 2).reshape(-1)
    lib_ms = cuda_ms(torch, lambda: torch.index_select(fv.reshape(-1, C), 0, flat), 20)
    del g_p
    b_ms, b_by = bound(N * K * 4 + M * C * 4 + K * N * C * 4, 0.0)
    shape = [N, M, K, C]
    emit(dict(phase='kernel', name='gather', shape=shape, agree=exact, exact=exact,
              max_abs_err=err, tolerance='exact (bit-equal)', ms=ms, plain_ms=plain_ms,
              library_ms=lib_ms, library='torch.index_select of the flattened rows',
              bound_ms=b_ms, bound_by=b_by))
    if not exact:
        raise AssertionError(f'gather differs from its plain version (err {err})')
    rows['gather'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=lib_ms, shape=shape)

    # Interpolation over the gathered rows (the decoder's k-prefix of 8).
    interp_g = lambda: t_attn.fused_knn_interp(qpos, pos2, feats2, KI, knn=knn,  # noqa: E731
                                               gathered=g)
    o_k = interp_g()
    o_p = t_attn.interp_g_plain(kd, g, KI, 1e-4)
    o_i = t_attn.fused_knn_interp(qpos, pos2, feats2, KI, knn=knn)
    torch.cuda.synchronize()
    err = max_err(o_k, o_p)
    ok = bool(torch.allclose(o_k, o_p, atol=1e-5, rtol=1e-5))
    route_diff = max_err(o_k, o_i)
    ms = cuda_ms(torch, interp_g, 20)
    e_ms = interp_g_entry_ms(torch, t_attn, 'interp_g', kd, g, KI)
    plain_ms = cuda_ms(torch, lambda: t_attn.interp_g_plain(kd, g, KI, 1e-4), 5)
    idx_ms = cuda_ms(torch, lambda: t_attn.fused_knn_interp(qpos, pos2, feats2, KI,
                                                             knn=knn), 20)
    w = 1.0 / (torch.sqrt(torch.clamp(kd[..., :KI], min=0.0)) + 1e-4)
    wn = (w / w.sum(-1, keepdim=True)).transpose(1, 2).contiguous()
    gf = g[:, :KI, :, :E]
    lib_ms = cuda_ms(torch, lambda: torch.einsum('bkn,bknc->bnc', wn, gf), 20)
    b_ms, b_by = bound(N * KI * 4 + N * KI * E * 4 + N * E * 4, 2.0 * N * KI * E)
    shape = [N, M, KI, E]
    emit(dict(phase='kernel', name='interp_g', shape=shape, agree=ok, max_abs_err=err,
              tolerance='atol 1e-5, rtol 1e-5', index_route_max_abs_diff=route_diff,
              ms=ms, entry_ms=e_ms, plain_ms=plain_ms, library_ms=lib_ms,
              library="torch.einsum('bkn,bknc->bnc') of the normalised weights and rows",
              index_route_interp_ms=idx_ms, bound_ms=b_ms, bound_by=b_by,
              parent_ms_perf_md=_PARENT_MS.get('interp_g'),
              parent_entry_ms_perf_md=_PARENT_ENTRY_MS.get('interp_g')))
    if not ok:
        raise AssertionError(f'interp_g disagrees: max abs err {err}')
    rows['interp_g'] = dict(max_abs_err=err, ms=ms, entry_ms=e_ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, shape=shape)

    # Attention over the gathered rows, and the two routes at M = 2124.
    attn_g = lambda gg, cd=torch.float32: t_attn.fused_knn_vector_attention(  # noqa: E731
        q_proj, qpos, feats2, pos2, params, K, gathered=gg, compute_dtype=cd)
    index = lambda: t_attn._attn_cuda(qpos, q_proj, ki, pos2, feats2, params, K,  # noqa: E731
                                      False)
    with torch.no_grad():
        kv_pre = torch.cat([feats2 @ params['to_k']['kernel'],
                            feats2 @ params['to_v']['kernel']], -1).contiguous()
    # The index route in premul mode (key set projected first), which
    # use_premul's TPU rule does not pick at M = 2124.
    premul = lambda: t_attn._attn_cuda(qpos, q_proj, ki, pos2, kv_pre, params, K,  # noqa: E731
                                       True)
    macs, nbytes = attn_fwd_work(N * K, N, 0, 0, D, E, H, P, True)
    shape = [N, M, K, D, E]
    row, o_k = attn_fwd_line(torch, 'attn_g', lambda: attn_g(g),
                             lambda: t_attn.attn_g_plain(qpos, q_proj, g, params, K),
                             macs, nbytes + N * K * C * 4, shape)
    with torch.no_grad():
        o_i = index()
        torch.cuda.synchronize()
        # The same rows through the index route's per-row mode: the same bits.
        route_diff = max_err(o_k, o_i)
        del o_k, o_i
        routes = dict(route_index_per_row_attn_ms=cuda_ms(torch, index, 3),
                      route_index_premul_attn_ms=cuda_ms(torch, premul, 3),
                      route_gather_plus_attn_g_ms=cuda_ms(torch, lambda: attn_g(gather()), 3))
    emit(dict(phase='route', name='attn_g_vs_index_route', shape=shape,
              index_route_max_abs_diff=route_diff, **routes))
    if route_diff != 0.0:
        raise AssertionError(f'attn_g and the per-row index route differ on the same rows '
                             f'({route_diff})')
    rows['attn_g'] = dict(row, index_route_max_abs_diff=route_diff, **routes)
    del g
    torch.cuda.empty_cache()

    # The bf16 mode of the three kernels on the same chunk (precision='fast').
    bf = torch.bfloat16
    gather_b = lambda: t_attn.knn_gather_rows(pos2, feats2, knn, K,  # noqa: E731
                                              compute_dtype=bf)
    g, g_2 = gather_b(), gather_b()
    g_p = t_attn.gather_rows_plain(fv, ki, K, bf)
    torch.cuda.synchronize()
    exact = bool(torch.equal(g, g_p)) and bool(torch.equal(g, g_2))
    err = max_err(g, g_p)
    del g_p, g_2
    ms = cuda_ms(torch, gather_b, 20)
    plain_ms = cuda_ms(torch, lambda: t_attn.gather_rows_plain(fv, ki, K, bf), 5)
    fvb = t_attn.round_bf16(fv)
    lib_ms = cuda_ms(torch, lambda: torch.index_select(fvb.reshape(-1, C), 0, flat), 20)
    b_ms, b_by = bound(N * K * 4 + M * C * 4 + K * N * C * 4, 0.0)
    shape = [N, M, K, C]
    rows['gather_bf16'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=lib_ms, shape=shape,
                               share_of_bound=b_ms / ms, tflop_s=0.0,
                               f32_kernel_ms=rows['gather']['ms'],
                               storage='f32 (bf16 values)')
    emit(dict(phase='kernel', name='gather_bf16', agree=exact, exact=exact,
              tolerance='exact (bit-equal), twice the same bits',
              library='torch.index_select of the bf16-rounded rows (the rounding not timed)',
              **rows['gather_bf16']))
    if not exact:
        raise AssertionError(f'gather_bf16 differs from its plain version (err {err})')

    gf = g[:, :KI, :, :E]
    b_ms, b_by = bound(N * KI * 4 + N * KI * E * 4 + N * E * 4, 2.0 * N * KI * E)
    interp_gb = lambda: t_attn.fused_knn_interp(qpos, pos2, feats2, KI, knn=knn,  # noqa: E731
                                                gathered=g, compute_dtype=bf)
    rows['interp_g_bf16'] = interp_bf16_line(
        torch, 'interp_g_bf16', interp_gb, lambda: t_attn.interp_g_plain(kd, g, KI, 1e-4, bf),
        lambda: torch.einsum('bkn,bknc->bnc', wn, gf),
        "torch.einsum('bkn,bknc->bnc') of the normalised weights and bf16 rows", b_ms, b_by,
        [N, M, KI, E], rows['interp_g']['ms'], 2.0 * N * KI * E,
        entry=lambda: interp_g_entry_ms(torch, t_attn, 'interp_g_bf16', kd, g, KI),
        parent=_PARENT_MS.get('interp_g_bf16'),
        parent_entry=_PARENT_ENTRY_MS.get('interp_g_bf16'))
    o_k = interp_gb()
    o_i = t_attn.fused_knn_interp(qpos, pos2, feats2, KI, knn=knn, compute_dtype=bf)
    torch.cuda.synchronize()
    rows['interp_g_bf16']['index_route_max_abs_diff'] = max_err(o_k, o_i)
    if not torch.equal(o_k, o_i):
        raise AssertionError('interp_g_bf16 and the index route\'s interp_bf16 differ')

    row, o_k = attn_fwd_line(torch, 'attn_g_bf16', lambda: attn_g(g, bf),
                             lambda: t_attn.attn_g_plain(qpos, q_proj, g, params, K, bf),
                             macs, nbytes + N * K * C * 4, [N, M, K, D, E], bf16=True,
                             f32_call=lambda: attn_g(g), f32_ms=rows['attn_g']['ms'])
    index_b = lambda: t_attn._attn_cuda(qpos, q_proj, ki, pos2, feats2,  # noqa: E731
                                        params, K, False, True)
    with torch.no_grad():
        o_i = index_b()
        torch.cuda.synchronize()
        route_diff = max_err(o_k, o_i)
        del o_k, o_i
        routes = dict(route_index_per_row_attn_ms=cuda_ms(torch, index_b, 3),
                      route_gather_plus_attn_g_ms=cuda_ms(torch, lambda: attn_g(gather_b(), bf),
                                                          3))
    emit(dict(phase='route', name='attn_g_bf16_vs_index_route', shape=[N, M, K, D, E],
              index_route_max_abs_diff=route_diff, **routes))
    if route_diff != 0.0:
        raise AssertionError(f'attn_g_bf16 and the per-row index route differ on the same '
                             f'rows ({route_diff})')
    rows['attn_g_bf16'] = dict(row, index_route_max_abs_diff=route_diff, **routes)


# The bf16 kernels of the 'fast' scenes, and the f32 kernels they stand in for.
_FAST = ('interp_bf16', 'attn_bf16', 'gather_bf16', 'interp_g_bf16', 'attn_g_bf16')
_FAST_F32 = ('interp', 'attn', 'gather', 'interp_g', 'attn_g')


def flip_stats(p, p_ref):
    """Densities p that fall on the other side of 0.5 than p_ref: (share,
    count, largest |p_ref - 0.5| among them, largest |p - 0.5| among them)."""
    flips = (p >= 0.5) != (p_ref >= 0.5)
    n = int(flips.sum())
    far = lambda x: float((x[flips] - 0.5).abs().max()) if n else 0.0  # noqa: E731
    return n / p.numel(), n, far(p_ref), far(p)


def fast_scene(torch, dev, smi, name, f32):
    """One dense scene of main_path / main_path_cv1 again, with the same
    seeded models, cloud and grid, through InferenceEngine(precision='fast'):
    one warm-up chunk, then encode + decode timed with the launch counters
    zeroed just before and read just after. Gates: the bf16 kernels launched
    (per chunk: interpolation 1, attention 2; the shared route's gather 1)
    and no f32 interpolation, gather or attention kernel; finite outputs of
    the expected shape; at most 0.5% of densities across 0.5 against the f32
    scene. :return the launch counts."""
    from occlusions4d_torch.evaluate import InferenceEngine
    from occlusions4d_torch.ops import _build
    cfg, (encoder, decoder) = f32['cfg'], f32['models']
    queries, pcl = f32['queries'], f32['pcl']
    engine = InferenceEngine(dict(encoder=encoder, decoder=decoder, device=dev),
                             cfg.color_mode, f32['seg'], cfg.semantic_classes,
                             track_mode='none', implicit_batch_size=_CHUNK, precision='fast')
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
    chunks = -(-queries.shape[0] // _CHUNK)
    shared = name == 'cv1'
    expect = dict({k: 0 for k in _FAST_F32}, interp_bf16=0 if shared else chunks,
                  attn_bf16=0 if shared else 2 * chunks, gather_bf16=chunks if shared else 0,
                  interp_g_bf16=chunks if shared else 0, attn_g_bf16=2 * chunks if shared else 0)
    counts_ok = all(counts.get(k, 0) == v for k, v in expect.items())
    finite = bool(torch.isfinite(out).all())
    share, n, far_f32, far_fast = flip_stats(out[:, 0], f32['density'])
    scene_ms = (t2 - t0) * 1e3
    emit(dict(phase='main_path_fast', model=name, precision=engine.precision,
              queries=int(queries.shape[0]), chunk=_CHUNK, chunks=chunks,
              out_shape=list(out.shape), finite=finite, encode_ms=(t1 - t0) * 1e3,
              decode_ms=(t2 - t1) * 1e3, scene_ms=scene_ms, f32_scene_ms=f32['scene_ms'],
              f32_decode_ms=f32['decode_ms'], scene_speedup=f32['scene_ms'] / scene_ms,
              queries_per_s=queries.shape[0] / (t2 - t1),
              density_flip_share=share, density_flips=n, flip_max_abs_p_f32_minus_half=far_f32,
              flip_max_abs_p_fast_minus_half=far_fast,
              density_max_abs_diff_vs_f32=max_err(out[:, 0], f32['density']),
              flip_gate='at most 0.5% of densities across 0.5 against the f32 scene',
              launches=counts, expected_launches=expect, gpu=smi))
    if not finite or out.shape[0] != queries.shape[0] or engine.precision != 'fast':
        raise AssertionError(f'main_path_fast {name}: output not finite or wrong shape')
    if not counts_ok:
        raise AssertionError(f'main_path_fast {name}: launches {counts} differ from {expect}')
    if share > 0.005:
        raise AssertionError(f'main_path_fast {name}: {share:.4%} of densities cross 0.5')
    return counts


# The eval driver (phase eval_driver): both committed anchors, each
# per-frame metric within max(0.02, 3%) of its committed value over the
# 3-step prefix, and the learned-quality floors: tests/test_anchor.py's
# recipe through tests/anchor_recipe.py.
# The anchors' mini-models decode on the index route: FPS on 256 points (the
# one-block launch), the brute kNN, the interpolation and both attention
# layers, f32 or bf16.
_EVAL_F32 = ('fps', 'knn_brute', 'interp', 'attn')
_EVAL_FAST = ('fps', 'knn_brute', 'interp_bf16', 'attn_bf16')
# gv1 at full width on a synthetic GREATER scene: the gv1 recipe's data
# settings (MIGRATION.md: n_data_rnd 14336, video_len 12, frame_skip 2,
# pt_cube_bounds 5, past_frames 4) and images large enough that every example
# fills the 14336 input points.
_GV1_EVAL = dict(_GV1, n_data_rnd=14336, video_len=12, frame_skip=2, pt_cube_bounds=5.0,
                 past_frames=4)
_GV1_SCENE = dict(num_scenes=1, num_views=3, num_frames=30, image_size=128, num_objects=5)
_GV1_EVAL_STEPS = 1
# The eval driver's gv1 runs (phases eval_driver and reference_pth) take a
# quarter of the dense grid: the host metrics' 1-NN, most of a frame's
# wall, scales with the queries (a full grid took 138-171 s for 4 frames).
_GV1_EVAL_SAMPLE = _NUM_SAMPLE // 8        # a quarter before the time budget's cut.
# The anchors' 'fast' runs (their deltas printed, not gated): the first
# step, where the f32 runs take EVAL_STEPS (3 before the time budget's cut).
_EVAL_FAST_STEPS = 1


def quiet_logger(log_dir, context='test'):
    """The driver's StepLogger without its stdout handler (the log goes to
    <log_dir>/<context>.log; this script's standard output stays JSON)."""
    import logging
    from occlusions4d_torch.utils.logvis import StepLogger
    logger = StepLogger(log_dir=log_dir, context=context)
    for h in list(logger.logger.handlers):
        if not isinstance(h, logging.FileHandler):
            logger.logger.removeHandler(h)
    return logger


def metric_deltas(per_frame, committed):
    """Per metric: the largest |got - committed| over the prefix's frames,
    and whether every frame holds max(0.02, 3%)."""
    out = {}
    for got, ref in zip(per_frame, committed['per_frame']):
        for k, rv in ref.items():
            if k in ('step', 'time_idx'):
                continue
            d = abs(got[k] - rv)
            o = out.setdefault(k, dict(max_abs_delta=0.0, within=True))
            o['max_abs_delta'] = max(o['max_abs_delta'], d)
            o['within'] = o['within'] and d <= max(0.02, 0.03 * abs(rv))
    return out


def floors_hold(kind, mean):
    import anchor_recipe
    fl = anchor_recipe.FLOORS[kind]
    ok = all(mean[k] > fl[k] for k in fl if k != 'chamfer_max')
    return ok and math.isfinite(mean['chamfer']) and mean['chamfer'] < fl['chamfer_max']


def run_driver(torch, argv, log, device='cuda', devices=None):
    """One in-process test_driver.main on the card (the engine over
    `devices` where given) with the launch counters zeroed just before and
    read just after. :return (summary, launches, wall s, the loop's
    PhaseTimer summary unrounded)."""
    from occlusions4d_torch.config import test_args
    from occlusions4d_torch.evaluate import test_driver
    from occlusions4d_torch.ops import _build
    args = test_args(argv)
    logger = quiet_logger(args.log_path)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.time()
    summary = test_driver.main(args, logger=logger, device=device, devices=devices)
    torch.cuda.synchronize()
    wall = time.time() - t0
    split = {k: v[0] for k, v in logger.last_eval_timer.summary().items()}
    return summary, _build.launch_counts(), wall, split


def gv1_eval_setup(torch, dev, root, steps=_GV1_EVAL_STEPS, num_sample=_NUM_SAMPLE):
    """gv1 at full width for the eval driver: the seeded weights of phase 4
    through from_jax_params, a synthetic GREATER scene under `root` in which
    every example fills the 14336 input points, the test loader built from
    _train_dset_args (`steps` examples), `num_sample` grid queries,
    --save_metrics.
    :return dict(cfg, args, engine, data_kind, loader, sizes (input points
    before padding per example), scene_gen_s)."""
    from occlusions4d_torch.config import TestConfig, TrainConfig
    from occlusions4d_torch.data import create_test_loader, synthetic
    from occlusions4d_torch.data.loader import _train_dset_args
    from occlusions4d_torch.evaluate import InferenceEngine
    cfg = TrainConfig(**_GV1_EVAL)
    encoder, decoder, _ = seeded_models(torch, cfg, dev, 1)
    data = os.path.join(root, 'data')
    t0 = time.time()
    synthetic.make_greater_dataset(data, stages=('test',), **_GV1_SCENE)
    gen_s = time.time() - t0
    args = TestConfig(data_path=os.path.join(data, 'test'), num_sample=num_sample,
                      point_sample_mode='grid', save_metrics=True,
                      implicit_batch_size=_CHUNK, use_json=False, num_workers=4, seed=7,
                      use_data_frac=(steps + 0.5) / 120,
                      log_path=os.path.join(root, 'logs'), test_tag='gv1', min_z=cfg.min_z,
                      pt_cube_bounds=cfg.pt_cube_bounds, cr_cube_bounds=cfg.cr_cube_bounds,
                      color_mode=cfg.color_mode, tracking_lw=cfg.tracking_lw)
    data_kind, loader = create_test_loader(args, _train_dset_args(cfg, 'greater', None),
                                           quiet_logger(args.log_path))
    sizes = [int(loader.dataset[i]['meta_data']['pcl_input_size'])
             for i in range(len(loader.dataset))]
    engine = InferenceEngine(dict(encoder=encoder, decoder=decoder, device=dev),
                             cfg.color_mode, False, cfg.semantic_classes,
                             track_mode='none', implicit_batch_size=_CHUNK)
    return dict(cfg=cfg, args=args, engine=engine, data_kind=data_kind, loader=loader,
                sizes=sizes, scene_gen_s=gen_s)


def run_gv1(torch, gv, **overrides):
    """One run_test over gv1_eval_setup's loader and engine (TestConfig
    fields replaced by `overrides`), the launch counters zeroed just before
    and read just after. :return (summary, launches, wall s, split)."""
    import dataclasses
    from occlusions4d_torch.evaluate import run_test
    from occlusions4d_torch.ops import _build
    args = dataclasses.replace(gv['args'], **overrides)
    logger = quiet_logger(args.log_path)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.time()
    summary = run_test(args, gv['engine'], gv['data_kind'], gv['loader'], logger)
    torch.cuda.synchronize()
    wall = time.time() - t0
    split = {k: v[0] for k, v in logger.last_eval_timer.summary().items()}
    return summary, _build.launch_counts(), wall, split


# The GREATER anchor's overlap-against-serial timing (phase eval_driver):
# the pipelined and the serial loop in the order A B B A, so that neither
# holds the phase's first driver call alone.
_OVERLAP_ORDER = (('f32', 'true'), ('f32_serial', 'false'), ('f32_serial_2', 'false'),
                  ('f32_2', 'true'))


def eval_driver(torch, dev, smi, path_counts):
    """Phase eval_driver: the port's eval driver (python -m
    occlusions4d_torch.evaluate) on both committed anchors and on gv1 at full
    width. :return {kernel: launches} summed over the phase's counted runs."""
    import glob
    import importlib.util
    import shutil
    import tempfile
    sys.path.append(os.path.join(_HERE, 'tests'))
    import anchor_recipe
    from occlusions4d_torch import native
    zlib_h = subprocess.run(['g++', '-E', '-x', 'c++', '-'], input='#include <zlib.h>\n',
                            capture_output=True, text=True).returncode == 0
    # Whether the imaging packages the JAX data plane uses are installed (the
    # port uses none of them), found without importing them.
    imaging = ('PIL', 'imageio', 'matplotlib')
    installed = {f'{m}_installed': importlib.util.find_spec(m) is not None for m in imaging}
    emit(dict(phase='eval_driver_env', native=native.status(), zlib_headers=zlib_h,
              png_decode='native fused (png_ops.cpp)' if native.status()['png']
              else 'data/png.py + the native frame pass', **installed))
    if not native.native_available():
        print('eval_driver: the native host library did not build; the data plane runs its '
              'numpy fallbacks', file=sys.stderr)
    tmp = tempfile.mkdtemp(prefix='o4d_eval_')
    counts_all = {}

    def add(counts):
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v

    try:
        for kind in ('greater', 'carla'):
            name = anchor_recipe.ANCHORS[kind]
            t0 = time.time()
            data = anchor_recipe.make_scene(kind, os.path.join(tmp, name))
            gen_s = time.time() - t0
            runs = ([(run, ('--eval_precision', 'auto', '--eval_overlap', ov))
                     for run, ov in _OVERLAP_ORDER] if kind == 'greater'
                    else [('f32', ('--eval_precision', 'auto'))])
            runs.append(('fast', ('--eval_precision', 'fast')))
            res, walls = {}, {}
            for run, extra in runs:
                log = os.path.join(tmp, name, run, 'anchor')
                steps = _EVAL_FAST_STEPS if run == 'fast' else anchor_recipe.EVAL_STEPS
                argv, committed = anchor_recipe.eval_argv(kind, data, log, extra, steps=steps)
                summary, counts, wall, split = run_driver(torch, argv, log)
                add(counts)
                frames = len(summary['per_frame'])
                deltas = metric_deltas(summary['per_frame'], committed)
                within = all(d['within'] for d in deltas.values())
                fl = floors_hold(kind, summary['mean'])
                want = _EVAL_FAST if run == 'fast' else _EVAL_F32
                launched = all(counts.get(k, 0) > 0 for k in want)
                if run == 'fast':
                    launched = launched and all(counts.get(k, 0) == 0 for k in _FAST_F32)
                res[run], walls[run] = summary, wall
                emit(dict(phase='eval_driver', anchor=name, run=run, frames=frames,
                          steps=steps, scene_gen_s=gen_s, wall_s=wall,
                          frame_wall_s=wall / max(frames, 1),
                          phase_split_s=split, scene_wall_s=summary['scene_wall_s'],
                          device_infer_share=split.get('device_infer', 0.0) / wall,
                          mean=summary['mean'], deltas_vs_committed=deltas,
                          within_tolerance=within, floors_hold=fl, launches=counts,
                          launches_per_frame={k: v / max(frames, 1) for k, v in counts.items()
                                              if v}, gpu=smi))
                if frames != steps or not launched:
                    raise AssertionError(f'eval_driver {name} {run}: {frames} frames, '
                                         f'launches {counts}')
                if run != 'fast' and not (within and fl):
                    raise AssertionError(f'eval_driver {name} {run}: committed metrics not '
                                         f'reproduced (within {within}, floors {fl}): {deltas}')
            if kind == 'greater':
                same = all(res[run]['per_frame'] == res['f32']['per_frame']
                           for run, _ in _OVERLAP_ORDER)
                overlap_s = [walls[run] for run, ov in _OVERLAP_ORDER if ov == 'true']
                serial_s = [walls[run] for run, ov in _OVERLAP_ORDER if ov == 'false']
                # The same run through the command line, in its own process.
                log = os.path.join(tmp, name, 'cli', 'anchor')
                argv, committed = anchor_recipe.eval_argv(kind, data, log,
                                                          ('--eval_precision', 'auto'))
                out_fp = os.path.join(_HERE, 'chiprun_out', 'eval_driver_cli.log')
                t0 = time.time()
                with open(out_fp, 'w') as fh:
                    proc = subprocess.run([sys.executable, '-m', 'occlusions4d_torch.evaluate',
                                           *argv], cwd=_HERE, stdout=fh,
                                          stderr=subprocess.STDOUT, timeout=600)
                cli_s = time.time() - t0
                found = glob.glob(os.path.join(os.path.dirname(log), 'test_*', 'metrics.json'))
                cli = json.load(open(found[0])) if proc.returncode == 0 and found else None
                cli_same = cli is not None and cli['per_frame'] == res['f32']['per_frame']
                emit(dict(phase='eval_driver_checks', anchor=name,
                          overlap_equals_serial=same, order=[r for r, _ in _OVERLAP_ORDER],
                          overlap_wall_s=overlap_s, serial_wall_s=serial_s,
                          overlap_over_serial=sum(overlap_s) / sum(serial_s),
                          cli_returncode=proc.returncode,
                          cli_wall_s=cli_s, cli_metrics_json=found[:1],
                          cli_equals_in_process=cli_same,
                          cli_phase_split_s=cli and cli['phase_split_s'],
                          cli_scene_wall_s=cli and cli['scene_wall_s']))
                if not same or not cli_same:
                    raise AssertionError(f'eval_driver: overlap equals serial {same}, the '
                                         f'command line equals the in-process run {cli_same} '
                                         f'(rc {proc.returncode}, see {out_fp})')

        # gv1 at full width: seeded weights, a synthetic GREATER scene.
        gv = gv1_eval_setup(torch, dev, os.path.join(tmp, 'gv1'), num_sample=_GV1_EVAL_SAMPLE)
        cfg, sizes = gv['cfg'], gv['sizes']
        summary, counts, wall, split = run_gv1(torch, gv)
        add(counts)
        frames = len(summary['per_frame'])
        finite = all(v is not None and math.isfinite(v) for m in summary['per_frame']
                     for v in m.values())
        launched = all(counts.get(k, 0) > 0 for k in _INFER)
        emit(dict(phase='eval_driver', model='gv1', n_points=cfg.n_points,
                  scene=_GV1_SCENE, scene_gen_s=gv['scene_gen_s'], steps=_GV1_EVAL_STEPS,
                  frames=frames, input_points_before_padding=sizes,
                  queries=_GV1_EVAL_SAMPLE,
                  wall_s=wall, frame_wall_s=wall / max(frames, 1), phase_split_s=split,
                  scene_wall_s=summary['scene_wall_s'],
                  device_infer_share=split.get('device_infer', 0.0) / wall,
                  mean=summary['mean'], finite=finite, launches=counts,
                  launches_per_frame={k: v / max(frames, 1) for k, v in counts.items() if v},
                  gpu=smi))
        if not finite or not launched or frames != _GV1_EVAL_STEPS * cfg.past_frames \
                or min(sizes) < cfg.n_points:
            raise AssertionError(f'eval_driver gv1: finite {finite}, launches {counts}, '
                                 f'frames {frames}, input sizes {sizes}')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    path_counts['eval_driver'] = counts_all
    return counts_all


# The train driver (phase train_driver): python -m occlusions4d_torch.train's
# main on the gv1 recipe at full width (MIGRATION.md:19-31, a synthetic
# GREATER dataset of _GV1_SCENE's size with train and val stages; 8 train
# steps and 1 val_aug step an epoch: the dataset's train / val sizes are 8:1
# and val needs a batch of 3), then the committed convergence recipe in
# three precisions.
_TD_GV1_ARGV = [
    '--name', 'gv1', '--num_workers', '4', '--batch_size', '3', '--up_down_blocks', '3',
    '--transition_factor', '3', '--pt_feat_dim', '36', '--pt_num_neighbors', '16',
    '--pt_norm_type', 'none', '--down_neighbors', '12', '--n_points', '14336',
    '--n_data_rnd', '14336', '--video_len', '12', '--frame_skip', '2', '--pt_cube_bounds', '5',
    '--cr_cube_bounds', '5', '--implicit_mlp_blocks', '6', '--local_implicit_mode',
    'attention', '--cross_attn_layers', '2', '--cross_attn_neighbors', '14',
    '--abstract_levels', '1', '--color_mode', 'rgb_nosigmoid', '--num_epochs', '2',
    '--density_lw', '1.0', '--color_lw', '1.0', '--segmentation_lw', '0.0', '--tracking_lw',
    '1.0', '--point_occupancy_radius', '0.2', '--air_sampling_ratio', '1.5',
    '--point_sample_bias', 'none', '--past_frames', '4', '--future_frames', '0',
    '--use_data_frac', str(3.1 / 120), '--seed', '3']
_TD_GV1_SCENE = dict(_GV1_SCENE, stages=('train', 'val'))
# The convergence recipe's three precisions: (name, extra flags).
_TD_CONV_MODES = (('f32', ()), ('bf16_decoder', ('--fused_decoder_dtype', 'bf16')),
                  ('mixed_precision', ('--mixed_precision', 'true')))
_TD_RESUME_RTOL = 1e-4


def epoch_spans(stage, fn):
    """fn() (one Trainer.run_epoch of `stage`) with the port's spans recorded
    (utils/profiling.py). :return (fn's result, steps run, viz exports,
    {span name: host s}: train.data, train.h2d, <stage>_step_<i> summed as
    '<stage>_step', train.guard, train.log_sync, train.viz, ...)."""
    from occlusions4d_torch.utils import profiling
    profiling.record_spans(True)     # from off: the store starts empty.
    try:
        out = fn()
    finally:
        profiling.record_spans(False)
    totals = profiling.span_totals()
    split = {}
    for name, t in totals.items():
        key = f'{stage}_step' if name.startswith(f'{stage}_step_') else name
        split[key] = split.get(key, 0.0) + t['host_ms'] / 1e3
    steps = sum(t['calls'] for n, t in totals.items() if n.startswith(f'{stage}_step_'))
    viz = totals.get('train.viz', {}).get('calls', 0)
    profiling.reset_spans()
    return out, steps, viz, split


def driver_run(torch, argv, log_root):
    """One train.main(train_args(argv)) on the card with the launch counters
    zeroed just before and read just after; every run_epoch's wall (around a
    synchronize) and its spans' host split (epoch_spans) recorded. :return (trainer, launches,
    wall s, epochs: [dict(epoch, stage, wall_s, split_s)])."""
    from occlusions4d_torch import train as t_train
    from occlusions4d_torch.config import train_args
    from occlusions4d_torch.ops import _build
    cfg = train_args(argv)
    epochs = []
    orig = t_train.Trainer.run_epoch

    def timed(self, epoch, stage, data_iter, num_steps=None):
        torch.cuda.synchronize()
        t0 = time.time()
        out, steps, viz, split = epoch_spans(
            stage, lambda: orig(self, epoch, stage, data_iter, num_steps))
        torch.cuda.synchronize()
        epochs.append(dict(epoch=epoch, stage=stage, wall_s=time.time() - t0,
                           steps=steps, viz=viz, split_s=split))
        return out

    t_train.Trainer.run_epoch = timed
    try:
        logger = quiet_logger(os.path.join(log_root, cfg.tag), context='train')
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.time()
        tr = t_train.main(cfg, logger=logger)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        t_train.Trainer.run_epoch = orig
    return tr, _build.launch_counts(), wall, epochs


def epoch_losses(tr):
    return {row['epoch']: {k: row[k] for k in ('train/total_loss', 'val_aug/total_loss')
                           if k in row} for row in tr.logger.scalar_history}


def convergence_child(spec):
    """A convergence run of phase train_driver in a process of its own
    (python3 chip_smoke.py --convergence <json>): train.main on the card;
    prints one JSON line: the logged losses by epoch, the learning rate at
    each epoch's last step, the step count, the launches and the wall."""
    import torch
    torch.set_num_threads(2)        # three such processes share the host's cores.
    spec = json.loads(spec)
    tr, counts, wall, _ = driver_run(torch, spec['argv'], spec['log_root'])
    spe = spec['steps_per_epoch']
    lrs = [float(tr.optimizer.lr(torch.tensor((e + 1) * spe - 1, device=tr.device)))
           for e in range(spec['num_epochs'])]
    print(json.dumps(dict(rows=epoch_losses(tr), lrs=lrs, step_count=tr.step_count,
                          launches=counts, wall_s=wall)), flush=True)
    return 0


def train_driver(torch, dev, smi, path_counts):
    """Phase train_driver: (a) the gv1 recipe through train.main for 2 epochs
    of train + val_aug, its checkpoints, a resume from model_0 re-running
    epoch 1, checkpoint.pkl through evaluate.load_models and one dense eval
    frame; (b) the committed convergence recipe in f32, with the bf16
    decoder and with mixed_precision. :return {kernel: launches} of (a)'s
    unbroken run."""
    import shutil
    import tempfile
    from occlusions4d_torch.data import create_train_val_loaders, synthetic
    from occlusions4d_torch.evaluate import InferenceEngine, load_models
    from occlusions4d_torch.ops import blind_points_numpy
    tmp = tempfile.mkdtemp(prefix='o4d_train_')
    try:
        data = os.path.join(tmp, 'gv1_data')
        t0 = time.time()
        synthetic.make_greater_dataset(data, **_TD_GV1_SCENE)
        gen_s = time.time() - t0
        base = _TD_GV1_ARGV + ['--data_path', data, '--checkpoint_root',
                               os.path.join(tmp, 'ck')]
        torch.cuda.reset_peak_memory_stats()
        tr, counts, wall, epochs = driver_run(torch, base, os.path.join(tmp, 'logs'))
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        path_counts['train_driver'] = counts
        out = tr.cfg.output_path
        ckpts = sorted(os.listdir(out))
        train_e = [e for e in epochs if e['stage'] == 'train']
        n_train = sum(e['steps'] for e in train_e)
        n_val = sum(e['steps'] for e in epochs if e['stage'] != 'train')
        # Every train step, val_aug step and viz export runs the forward
        # kernels once; the backward kernels run once a train step.
        forwards = n_train + n_val + sum(e['viz'] for e in epochs)
        per_step = {k: v / (n_train if k in ('attn_bwd', 'interp_bwd') else forwards)
                    for k, v in counts.items() if v}
        # Input points before padding of the first train examples.
        _, loader, _, _ = create_train_val_loaders(tr.cfg, tr.logger)
        loader.dataset.set_epoch(0)
        sizes = [int(loader.dataset[i]['meta_data']['pcl_input_size']) for i in range(3)]
        # Resume from model_0 and run epoch 1 again.
        rtr, _, r_wall, r_epochs = driver_run(
            torch, base + ['--resume', os.path.join(out, 'model_0.pkl'),
                           '--output_path', os.path.join(tmp, 'ck_resumed')],
            os.path.join(tmp, 'logs_resumed'))
        full, resumed = epoch_losses(tr), epoch_losses(rtr)
        rel = {k: abs(resumed[1][k] - full[1][k]) / max(abs(full[1][k]), 1e-12)
               for k in full[1]}
        bitwise = resumed[1] == full[1]
        # checkpoint.pkl through the eval driver's loader, one dense frame.
        L = load_models(os.path.join(out, 'checkpoint.pkl'), device=dev, logger=tr.logger)
        c = L['train_config']
        engine = InferenceEngine(L, c.color_mode, False, c.semantic_classes,
                                 track_mode='none', implicit_batch_size=_CHUNK)
        pcl = np.random.RandomState(0).rand(14336, 8).astype(np.float32) * 2 - 1
        queries = blind_points_numpy(_NUM_SAMPLE, c.min_z, c.cr_cube_bounds, 0, 'greater',
                                     c.cube_mode, 'grid')
        torch.cuda.synchronize()
        t0 = time.time()
        abstract, fg = engine.encode(pcl)
        dense = engine.decode_all(queries, abstract, fg, fetch=False)
        torch.cuda.synchronize()
        eval_ms = (time.time() - t0) * 1e3
        eval_ok = bool(torch.isfinite(dense).all()) and list(dense.shape) == [
            queries.shape[0], 5] and L['epoch'] == 1
        launched = all(counts.get(k, 0) > 0 for k in _TRAIN)
        ok = (ckpts == ['checkpoint.pkl', 'model_0.pkl', 'model_1.pkl'] and launched
              and n_train >= 6 and n_val >= 2 and eval_ok and rtr.start_epoch == 1
              and min(sizes) >= tr.cfg.n_points
              and all(v <= _TD_RESUME_RTOL for v in rel.values()) and len(rel) == 2
              and all(math.isfinite(v) for r in full.values() for v in r.values()))
        emit(dict(phase='train_driver', model='gv1', argv=_TD_GV1_ARGV, scene=_TD_GV1_SCENE,
                  scene_gen_s=gen_s, steps_per_epoch=train_e[0]['steps'],
                  input_points_before_padding=sizes, train_steps=n_train,
                  val_steps=n_val, wall_s=wall, epochs=epochs,
                  step_wall_ms=[1e3 * e['wall_s'] / max(e['steps'], 1) for e in train_e],
                  data_share=[e['split_s'].get('train.data', 0.0) / e['wall_s'] for e in train_e],
                  peak_mem_gib=peak_gb, losses=full, checkpoints=ckpts,
                  resumed_losses=resumed[1], resume_rel_diff=rel, resume_bitwise=bitwise,
                  resume_wall_s=r_wall, resume_epochs=r_epochs,
                  eval_frame_ms=eval_ms, eval_queries=int(queries.shape[0]),
                  eval_ok=eval_ok, launches=counts,
                  forwards=forwards, launches_per_train_step=per_step,
                  ok=ok, gpu=smi))
        if not ok:
            raise AssertionError(f'train_driver gv1 failed: checkpoints {ckpts}, launches '
                                 f'{counts}, resume {rel}, eval {eval_ok}, input sizes '
                                 f'{sizes}')
        del tr, rtr, L, engine, abstract, fg, dense
        torch.cuda.empty_cache()

        # (b) The committed convergence recipe in three precisions.
        art = json.load(open(os.path.join(_HERE, 'tests', 'assets', 'convergence',
                                          'trajectory.json')))
        conv = os.path.join(tmp, 'conv_data')
        synthetic.make_greater_dataset(conv, **dict(art['gen'],
                                                    stages=tuple(art['gen']['stages'])))
        spe = art['steps_per_epoch']
        # The three runs at once, a child process each (python3 chip_smoke.py
        # --convergence): their tiny steps are host-bound, and the host has
        # the cores.
        procs = {}
        try:
            t0 = time.time()
            for name, extra in _TD_CONV_MODES:
                argv = list(art['argv']) + list(extra) + [
                    '--data_path', conv, '--name', f'conv_{name}',
                    '--checkpoint_root', os.path.join(tmp, 'ck_conv')]
                spec = json.dumps(dict(argv=argv, log_root=os.path.join(tmp, 'logs', name),
                                       steps_per_epoch=spe, num_epochs=art['num_epochs']))
                out_fp = os.path.join(tmp, f'conv_{name}.out')
                err_fp = os.path.join(_HERE, 'chiprun_out', f'train_driver_conv_{name}.log')
                with open(out_fp, 'w') as fo, open(err_fp, 'w') as fe:
                    procs[name] = (subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__), '--convergence', spec],
                        cwd=_HERE, stdout=fo, stderr=fe, text=True), out_fp, err_fp)
            for p, _, _ in procs.values():
                p.wait(timeout=900)
            conv_wall = time.time() - t0
        finally:
            for p, _, _ in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for name, extra in _TD_CONV_MODES:
            p, out_fp, err_fp = procs[name]
            with open(out_fp) as f:
                lines = [ln for ln in f.read().splitlines() if ln.startswith('{')]
            if p.returncode != 0 or not lines:
                raise AssertionError(f'train_driver convergence {name}: its process exited '
                                     f'{p.returncode} (see {err_fp})')
            res = json.loads(lines[-1])
            rows = {int(k): v for k, v in res['rows'].items()}
            lrs = res['lrs']
            drops = [e for e in range(1, len(lrs)) if lrs[e] < lrs[e - 1]]
            lr_ok = drops == art['lr_milestone_epochs'] and all(
                abs(lrs[e] / lrs[e - 1] - art['lr_decay']) < 1e-6 for e in drops)
            vals = [rows[e]['val_aug/total_loss'] for e in range(art['num_epochs'])]
            trains = [rows[e]['train/total_loss'] for e in range(art['num_epochs'])]
            finite = all(math.isfinite(v) for v in vals + trains)
            falls = finite and min(vals[-3:]) < min(vals[:3])
            emit(dict(phase='train_driver_convergence', run=name, extra=list(extra),
                      epochs=art['num_epochs'], steps_per_epoch=spe, wall_s=res['wall_s'],
                      three_runs_wall_s=conv_wall, train_loss=trains, val_loss=vals, lr=lrs,
                      lr_drops_at=drops, lr_milestones_ok=lr_ok,
                      val_best_last3=min(vals[-3:]), val_best_first3=min(vals[:3]),
                      val_falls=falls, step_count=res['step_count'],
                      launches=res['launches'],
                      committed_jax_cpu_val_loss=[e['val_loss'] for e in art['epochs']],
                      gpu=smi))
            if not (lr_ok and falls and res['step_count'] == art['num_epochs'] * spe):
                raise AssertionError(f'train_driver convergence {name}: LR drops at {drops}, '
                                     f'val losses {vals}')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return path_counts['train_driver']


# Phase reference_pth: the eval driver on a reference-layout .pth of the gv1
# weights of phase eval_driver (seed 1), beside the same weights' .pkl, on
# the synthetic gv1 scene at _REF_EVAL_SAMPLE queries, then a train.main
# warm start from it.
_REF_EPOCH = 0
# The reference .pth's eval: 32768 grid queries (131072 before the time
# budget's cut: the host metrics' time scales with them).
_REF_EVAL_SAMPLE = _NUM_SAMPLE // 16
# The warm start's train stage: 10 examples, 3 steps of batch 3, no val step.
_REF_TRAIN_FRAC = str(10 / 960)


def write_reference_pth(torch, path, encoder, decoder, cfg, encoder_args, decoder_args,
                        dset_args, epoch):
    """The reference train.py's torch.save dict of two torch modules: their
    state dicts (the decoder's first block under the legacy 'pt_block.'
    name), the constructor args (pcl_args with the reference's
    mixed_precision key), dset_args, the args Namespace, the epoch, and the
    optimizer, lr_scheduler and scaler state dicts of torch's Adam,
    MultiStepLR and GradScaler."""
    import argparse
    import collections
    dec = collections.OrderedDict(
        ('pt_block.' + k[len('pt_blocks.0.'):] if k.startswith('pt_blocks.0.') else k,
         v.detach().cpu()) for k, v in decoder.state_dict().items())
    if not any(k.startswith('pt_block.') for k in dec):
        raise AssertionError('the decoder has no first attention block to rename')
    p = [torch.nn.Parameter(torch.ones(3))]
    opt = torch.optim.Adam(p, lr=cfg.learn_rate)
    p[0].grad = torch.ones(3)
    opt.step()
    sched = torch.optim.lr_scheduler.MultiStepLR(opt, [8, 12, 16], cfg.lr_decay)
    torch.save(dict(pcl_net=collections.OrderedDict((k, v.detach().cpu()) for k, v in
                                                    encoder.state_dict().items()),
                    implicit_net=dec, pcl_args=dict(encoder_args, mixed_precision=False),
                    implicit_args=dict(decoder_args), dset_args=dict(dset_args),
                    args=argparse.Namespace(**vars(cfg)), epoch=epoch,
                    optimizer=opt.state_dict(), lr_scheduler=sched.state_dict(),
                    scaler=torch.amp.GradScaler('cuda').state_dict()), path)


def reference_pth(torch, dev, smi, path_counts, train_data):
    """Phase reference_pth: the gv1 weights written as a native .pkl and as
    a reference .pth; the .pkl through the eval driver in this process
    (test_driver.main, launches counted), the .pth through python -m
    occlusions4d_torch.evaluate in its own; their per-frame metrics must be
    equal. Then train.main warm-starts from the .pth on the gv1 recipe: its
    step count (epoch + 1) x steps_per_epoch + the steps run, finite losses."""
    import shutil
    import tempfile
    from occlusions4d_torch.checkpoint import save_checkpoint, to_jax_params
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.data import synthetic
    from occlusions4d_torch.data.loader import _train_dset_args
    from occlusions4d_torch.models import build_models
    tmp = tempfile.mkdtemp(prefix='o4d_pth_')
    try:
        cfg = TrainConfig(**_GV1_EVAL)
        encoder, decoder, _ = seeded_models(torch, cfg, dev, 1)
        _, _, enc_args, dec_args = build_models(cfg)
        dset_args = _train_dset_args(cfg, 'greater', None)
        state = dict(params=dict(encoder=to_jax_params(encoder.state_dict()),
                                 decoder=to_jax_params(decoder.state_dict(), True)),
                     step=np.asarray(0, np.int32))
        save_checkpoint(os.path.join(tmp, 'pkl'), _REF_EPOCH, state,
                        meta=dict(config=dict(vars(cfg)), encoder_args=enc_args,
                                  decoder_args=dec_args, dset_args=dset_args,
                                  data_kind='greater'))
        pth = os.path.join(tmp, 'gv1.pth')
        write_reference_pth(torch, pth, encoder, decoder, cfg, enc_args, dec_args, dset_args,
                            _REF_EPOCH)
        del encoder, decoder
        data = os.path.join(tmp, 'data')
        synthetic.make_greater_dataset(data, stages=('test',), **_GV1_SCENE)

        def argv(resume, log):
            return ['--resume', resume, '--data_path', data, '--num_sample',
                    str(_REF_EVAL_SAMPLE), '--point_sample_mode', 'grid', '--save_metrics',
                    'true', '--implicit_batch_size', str(_CHUNK), '--use_json', 'false',
                    '--num_workers', '4', '--seed', '7', '--use_data_frac',
                    str((_GV1_EVAL_STEPS + 0.5) / 120), '--log_path', log]

        # The .pth through the command line while the .pkl runs here: the
        # walls overlap, the metrics do not depend on it.
        log_pth = os.path.join(tmp, 'eval_pth', 'run')
        out_fp = os.path.join(_HERE, 'chiprun_out', 'reference_pth_cli.log')
        t0 = time.time()
        with open(out_fp, 'w') as fh:
            proc = subprocess.Popen([sys.executable, '-m', 'occlusions4d_torch.evaluate',
                                     *argv(pth, log_pth)], cwd=_HERE, stdout=fh,
                                    stderr=subprocess.STDOUT)
            try:
                log_pkl = os.path.join(tmp, 'eval_pkl', 'run')
                summary, counts, wall, split = run_driver(
                    torch, argv(os.path.join(tmp, 'pkl', 'checkpoint.pkl'), log_pkl), log_pkl)
                proc.wait(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        cli_s = time.time() - t0
        path_counts['reference_pth'] = counts
        import glob
        found = glob.glob(os.path.join(os.path.dirname(log_pth), 'test_*', 'metrics.json'))
        cli = json.load(open(found[0])) if proc.returncode == 0 and found else None
        frames = len(summary['per_frame'])
        same = cli is not None and cli['per_frame'] == summary['per_frame']
        finite = all(v is not None and math.isfinite(v) for m in summary['per_frame']
                     for v in m.values())
        launched = all(counts.get(k, 0) > 0 for k in _INFER)
        loaded_pth = 'Loading weights from: ' + pth in open(out_fp).read()

        # train.main warm-started from the .pth on the gv1 recipe.
        argv_t = _TD_GV1_ARGV + ['--data_path', train_data, '--checkpoint_root',
                                 os.path.join(tmp, 'ck'), '--resume', pth, '--num_epochs',
                                 str(_REF_EPOCH + 2), '--use_data_frac', _REF_TRAIN_FRAC]
        tr, t_counts, t_wall, epochs = driver_run(torch, argv_t, os.path.join(tmp, 'logs'))
        spe = epochs[0]['steps'] if epochs else 0
        losses = epoch_losses(tr)
        t_ok = (tr.start_epoch == _REF_EPOCH + 1 and spe > 0
                and tr.step_count == (_REF_EPOCH + 2) * spe
                and int(tr.optimizer.count) == spe
                and all(math.isfinite(v) for r in losses.values() for v in r.values())
                and len(losses) == 1 and all(t_counts.get(k, 0) > 0 for k in _TRAIN))
        ok = same and finite and launched and frames > 0 and loaded_pth and t_ok
        emit(dict(phase='reference_pth', model='gv1', queries=_REF_EVAL_SAMPLE,
                  frames=frames, concurrent=True, pkl_wall_s=wall, pkl_phase_split_s=split,
                  pth_cli_returncode=proc.returncode, pth_cli_wall_s=cli_s,
                  pth_loaded_as_pth=loaded_pth, per_frame_equal=same,
                  pkl_mean=summary['mean'], pth_mean=cli and cli['mean'], finite=finite,
                  launches=counts, warm_start=dict(
                      start_epoch=tr.start_epoch, steps_per_epoch=spe,
                      step_count=tr.step_count, adamw_count=int(tr.optimizer.count),
                      losses=losses, wall_s=t_wall, epochs=epochs, launches=t_counts),
                  ok=bool(ok), gpu=smi))
        if not ok:
            raise AssertionError(f'reference_pth failed: per-frame equal {same} (rc '
                                 f'{proc.returncode}, see {out_fp}), finite {finite}, '
                                 f'launches {counts}, warm start ok {t_ok}')
        del tr
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def batch_stats(encoder):
    return {k: v.detach().clone() for k, v in encoder.state_dict().items()
            if k.endswith(('running_mean', 'running_var'))}


def train_batchnorm(torch, dev, smi, path_counts):
    """Phase train_batchnorm: the gv1 train step with pt_norm_type 'batch'
    beside 'none', from the same seed, batch and generator: 1 warm-up + 3
    timed steps each (launches of the batch-norm steps counted), finite
    losses, running statistics that move every step; a val_aug (eval) step
    and a viz step that leave them as they were; then the encoder in eval
    mode (the running statistics) and one dense gv1 scene through
    InferenceEngine, finite."""
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.evaluate import InferenceEngine
    from occlusions4d_torch.ops import blind_points_numpy
    from occlusions4d_torch.train import Trainer
    out = {}
    for norm in ('none', 'batch'):
        cfg = TrainConfig(**dict(_GV1_TRAIN, pt_norm_type=norm))
        tr = Trainer(cfg, 'greater', 'cuda').init_state(seed=11, steps_per_epoch=100)
        batch = train_batch(torch, cfg, dev, seed=12)
        stats = batch_stats(tr.encoder)
        steps, counts, changed, peak_gb, split, warm_ms = run_train_phase(torch, tr, batch, 3)
        after = batch_stats(tr.encoder)
        moved = all(not torch.equal(after[k], v) for k, v in stats.items())
        out[norm] = dict(step_ms=[st['ms'] for st in steps], warmup_ms=warm_ms,
                         mean_step_ms=float(np.mean([st['ms'] for st in steps])),
                         losses=[st['total_loss'] for st in steps], split_ms=split,
                         peak_mem_gib=peak_gb, params_changed_max_abs=changed,
                         finite=all(np.isfinite(st['total_loss']) and st['grads_finite']
                                    and st['params_finite'] for st in steps),
                         statistics=len(stats), statistics_moved=moved, launches=counts)
        if norm == 'none':
            del tr
            torch.cuda.empty_cache()
    path_counts['train_batchnorm'] = out['batch']['launches']
    before = batch_stats(tr.encoder)
    gen = torch.Generator(dev).manual_seed(13)
    ev = tr._eval_step(batch, gen)
    viz = tr._viz_step(batch, gen)
    torch.cuda.synchronize()
    kept = all(torch.equal(v, before[k]) for k, v in batch_stats(tr.encoder).items())
    ev_ok = math.isfinite(float(ev['total_loss'])) and bool(torch.isfinite(
        viz['implicit_output']).all())
    # The dense scene with the running statistics.
    tr.encoder.eval()
    tr.decoder.eval()
    engine = InferenceEngine(dict(encoder=tr.encoder, decoder=tr.decoder, device=dev),
                             tr.cfg.color_mode, False, tr.cfg.semantic_classes,
                             track_mode='none', implicit_batch_size=_CHUNK)
    pcl = np.random.RandomState(14).rand(14336, 8).astype(np.float32) * 2 - 1
    queries = blind_points_numpy(_NUM_SAMPLE, tr.cfg.min_z, tr.cfg.cr_cube_bounds, 0,
                                 'greater', tr.cfg.cube_mode, 'grid')
    torch.cuda.synchronize()
    t0 = time.time()
    abstract, fg = engine.encode(pcl)
    dense = engine.decode_all(queries, abstract, fg, fetch=False)
    torch.cuda.synchronize()
    scene_ms = (time.time() - t0) * 1e3
    dense_ok = bool(torch.isfinite(dense).all()) and dense.shape[0] == queries.shape[0]
    bn = out['batch']
    ok = (bn['finite'] and out['none']['finite']
          and bn['statistics'] == 2 * _GV1_TRAIN['up_down_blocks']
          and bn['statistics_moved'] and kept and ev_ok and dense_ok
          and all(bn['launches'].get(k, 0) > 0 for k in _TRAIN))
    emit(dict(phase='train_batchnorm', model='gv1', n_points=_GV1_TRAIN['n_points'],
              batch_size=_GV1_TRAIN['batch_size'], frames=_GV1_TRAIN['past_frames'],
              runs=out, batch_over_none_step=bn['mean_step_ms'] / out['none']['mean_step_ms'],
              eval_and_viz_keep_statistics=kept, eval_viz_finite=ev_ok,
              dense_scene_ms=scene_ms, dense_queries=int(queries.shape[0]),
              dense_finite=dense_ok, ok=bool(ok), gpu=smi))
    if not ok:
        raise AssertionError(f'train_batchnorm failed: {out}, kept {kept}, eval/viz {ev_ok}, '
                             f'dense {dense_ok}')
    del tr, engine, abstract, fg, dense
    torch.cuda.empty_cache()


# Phase train_loader_workers: the train driver's epoch fed by thread and by
# process workers, interleaved A B B A in one process that builds both
# loaders before it touches CUDA (as train.main does); 6 train steps an
# epoch, after a 2-step warm-up.
_LW_FRAC = str(12.5 / 960)       # 4-step epochs (6 before the time budget's cut).
_LW_ORDER = ('thread', 'process', 'process', 'thread')


def loader_workers_child(spec):
    """The child process of phase train_loader_workers (python3
    chip_smoke.py --loader-workers <json>): both modes' loaders first, then
    the Trainer on the card, a warm-up, the A B B A epochs; prints one JSON
    line."""
    import torch
    from occlusions4d_torch.config import train_args
    from occlusions4d_torch.data import create_train_val_loaders
    from occlusions4d_torch.train import Trainer
    spec = json.loads(spec)
    logger = quiet_logger(spec['log'], context='train')
    logger.log_dir = None                   # no intermediate exports.
    loaders, cfgs = {}, {}
    for mode in ('thread', 'process'):
        cfgs[mode] = train_args(spec['argv'] + ['--worker_mode', mode])
        loaders[mode] = create_train_val_loaders(cfgs[mode], logger)[1]
    cuda_before = torch.cuda.is_initialized()
    tr = Trainer(cfgs['thread'], 'greater', logger=logger)
    tr.init_state(steps_per_epoch=loaders['thread'].steps_per_epoch)
    tr.run_epoch(0, 'train', loaders['thread'].epoch(0), num_steps=2)
    runs = []
    for i, mode in enumerate(_LW_ORDER):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        _, steps, _, split = epoch_spans(
            'train', lambda: tr.run_epoch(i + 1, 'train', loaders[mode].epoch(i + 1)))
        torch.cuda.synchronize()
        wall = time.time() - t0
        runs.append(dict(mode=mode, epoch=i + 1, steps=steps, wall_s=wall,
                         step_wall_ms=1e3 * wall / max(steps, 1),
                         data_share=split.get('train.data', 0.0) / wall, split_s=split,
                         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30))
    for ld in loaders.values():
        ld.close()
    print(json.dumps(dict(runs=runs, cuda_initialized_before_loaders=cuda_before,
                          workers=cfgs['thread'].num_workers,
                          batch_size=cfgs['thread'].batch_size,
                          step_count=tr.step_count)), flush=True)
    return 0


def train_loader_workers(torch, smi, train_data):
    """Phase train_loader_workers: loader_workers_child in its own process;
    per epoch the step wall, the data share and peak memory; the mean of
    each mode."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix='o4d_lw_')
    argv = _TD_GV1_ARGV + ['--data_path', train_data, '--checkpoint_root',
                           os.path.join(tmp, 'ck'), '--use_data_frac', _LW_FRAC,
                           '--output_path', '']
    spec = json.dumps(dict(argv=argv, log=os.path.join(tmp, 'logs')))
    out_fp = os.path.join(_HERE, 'chiprun_out', 'train_loader_workers.log')
    with open(out_fp, 'w') as fh:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), '--loader-workers',
                               spec], cwd=_HERE, stdout=subprocess.PIPE, stderr=fh,
                              text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{')]
    res = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    ok = res is not None and not res['cuda_initialized_before_loaders'] and all(
        r['steps'] > 0 for r in res['runs'])
    mean = {}
    if res is not None:
        for mode in ('thread', 'process'):
            rs = [r for r in res['runs'] if r['mode'] == mode]
            mean[mode] = {k: float(np.mean([r[k] for r in rs]))
                          for k in ('step_wall_ms', 'data_share', 'peak_mem_gib')}
    emit(dict(phase='train_loader_workers', model='gv1', order=list(_LW_ORDER),
              returncode=proc.returncode, result=res, mean=mean,
              process_over_thread_step=(mean['process']['step_wall_ms']
                                        / mean['thread']['step_wall_ms']) if mean else None,
              ok=bool(ok), gpu=smi))
    if not ok:
        raise AssertionError(f'train_loader_workers failed (rc {proc.returncode}, see '
                             f'{out_fp}): {res}')


def scatter_add_ms(torch, ki, dg, M, K, dev):
    """The scatter's library yardstick: one scatter_add_ of dg's first K row
    planes into a zeroed (B, M, C) tensor (the index expanded beforehand,
    not timed); returns (ms, what was timed)."""
    B, _, N, C = dg.shape
    idx = ki[..., :K].transpose(1, 2).reshape(B, K * N, 1).long().expand(B, K * N, C)
    src = dg[:, :K].reshape(B, K * N, C)
    out = torch.zeros((B, M, C), device=dev)
    return (cuda_ms(torch, lambda: out.scatter_add_(1, idx, src), 20),
            'scatter_add_ of the rows into a zeroed (B, M, C) tensor')


def segments(torch, offsets, chunk=64):
    """The longest key's rows and the number of 64-row summing chunks they
    span (csrc/inverse_index.cuh kChunk)."""
    off = offsets.long()
    seg = torch.diff(off)
    x = int(seg.argmax())
    s, f = int(off[x]), int(off[x + 1])
    return int(seg.max()), (f - 1) // chunk - s // chunk + 1


def interp_g_bwd_write_times(torch, t_attn, kd, go, k, E, buf, reps):
    """The gathered interpolation backward's library call and the card's
    write ceiling for its buffer `buf` (dg's shape, (B, k_ext, N, E + 3)),
    each by cuda_ms over `reps` calls: torch.mul of the normalised weights
    and go into the zeroed buffer's row slice, buffer and weights made
    outside the timing (library_ms) and inside it (library_whole_ms);
    buf.zero_() and o4d_fill16, a bare 16-byte store pass, with and without
    evict-first stores (fill16_wrote_values: a fill of 1.5 read back)."""
    dev = buf.device
    buf.zero_()
    w = 1.0 / (torch.sqrt(torch.clamp(kd[..., :k], min=0.0)) + 1e-4)
    wn = (w / w.sum(-1, keepdim=True)).transpose(1, 2)[..., None]
    lib_ms = cuda_ms(torch, lambda: torch.mul(wn, go[:, None], out=buf[:, :k, :, :E]), reps)

    def whole_library():
        out = torch.zeros(buf.shape, device=dev)
        wl = 1.0 / (torch.sqrt(torch.clamp(kd[..., :k], min=0.0)) + 1e-4)
        wln = (wl / wl.sum(-1, keepdim=True)).transpose(1, 2)[..., None]
        return torch.mul(wln, go[:, None], out=out[:, :k, :, :E])
    lib_whole_ms = cuda_ms(torch, whole_library, reps)
    fill = t_attn._build.library('interp').o4d_fill16
    fill.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                     ctypes.c_void_p]
    fill.restype = ctypes.c_int

    def fill16(evict_first, v=0.0):
        t_attn._build.check(fill(buf.data_ptr(), buf.numel(), v, evict_first,
                                 t_attn._build.stream_ptr(dev)), 'o4d_fill16')
    fill16(1, 1.5)
    torch.cuda.synchronize()
    return dict(library_ms=lib_ms, library_whole_ms=lib_whole_ms,
                fill16_wrote_values=bool((buf == 1.5).all()),
                zero_ms=cuda_ms(torch, buf.zero_, reps),
                fill16_ms=cuda_ms(torch, lambda: fill16(0), reps),
                fill16_evict_first_ms=cuda_ms(torch, lambda: fill16(1), reps))


def check_shared_gather_backward_kernels(torch, t_attn, dev, rng, params, E, rows):
    """scatter, interp_g_bwd, the decoder route's scatter + interp_bwd and
    attn_g_bwd at one cv1 train frame (3 examples of 17203 queries, each against its
    own 2124-point abstract cloud; K 14 gathered, interpolation over 8), each
    against its plain version (the attention one example at a time) and
    twice for the same bits; the gathered attention backward also against
    the per-row index route on the same rows (d(q_proj) and weight gradients
    bit-equal)."""
    B, N, M, K, KI, C = 3, _CV1_N, _CV1_M, 14, 8, E + 3
    D = params['attn_mlp_0']['kernel'].shape[0]
    H, P = params['attn_mlp_0']['kernel'].shape[1], params['pos_mlp_0']['kernel'].shape[1]
    tol = 'atol 5e-6 x max(1, max|plain|)'

    def rand(*shape, scale=None):
        a = rng.rand(*shape) * scale - scale / 2 if scale else rng.randn(*shape)
        return torch.tensor(a.astype(np.float32), device=dev)

    def agree(pairs):
        err = max(max_err(a, b) for a, b in pairs)
        scaled = max(max_err(a, b) / max(1.0, float(b.abs().max())) for a, b in pairs)
        return err, scaled, scaled <= 5e-6

    pos2, feats2, qpos = rand(B, M, 3, scale=10.0), rand(B, M, E), rand(B, N, 3, scale=10.0)
    knn = t_attn.knn_extract(qpos, pos2, K)
    ki, kd = knn
    with torch.no_grad():
        g = t_attn.knn_gather_rows(pos2, feats2, knn, K)

    # The scatter (the gather's VJP), the inverse-index build included.
    dg = rand(B, K, N, C)
    d1 = t_attn.gather_bwd(ki, dg, M, K)
    d2 = t_attn.gather_bwd(ki, dg, M, K)
    ref = t_attn.gather_bwd_plain(ki, dg, M, K)
    rows_i, offsets = t_attn.scatter_index(ki, M, K, K)
    index_ok = all(bool(torch.equal(a, b)) for a, b in zip(
        (rows_i, offsets), t_attn.scatter_index_plain(ki, M, K, K)))
    torch.cuda.synchronize()
    err, scaled, ok = agree([(d1, ref)])
    repro = max_err(d1, d2)
    ms = cuda_ms(torch, lambda: t_attn.gather_bwd(ki, dg, M, K), 20)
    index_ms = cuda_ms(torch, lambda: t_attn.scatter_index(ki, M, K, K), 20)
    plain_ms = cuda_ms(torch, lambda: t_attn.gather_bwd_plain(ki, dg, M, K), 5)
    lib_ms, lib_name = scatter_add_ms(torch, ki, dg, M, K, dev)
    flat = (ki.long() + M * torch.arange(B, device=dev).view(B, 1, 1)).transpose(1, 2)
    flat, dg_rows = flat.reshape(-1), dg.reshape(-1, C)
    index_add_ms = cuda_ms(torch, lambda: torch.zeros((B * M, C), device=dev).index_add_(
        0, flat, dg_rows), 20)
    seg, chunks = segments(torch, offsets)
    b_ms, b_by = bound(4 * (B * K * N * C + B * N * K + B * M * C), 1.0 * B * K * N * C)
    shape = [B, N, M, K, C]
    emit(dict(phase='kernel', name='scatter', shape=shape, agree=ok and index_ok,
              max_abs_err=err, max_scaled_err=scaled, tolerance=tol,
              index_equals_stable_sort=index_ok, repeat_max_abs_diff=repro, ms=ms,
              inverse_index_ms=index_ms, plain_ms=plain_ms, library_ms=lib_ms,
              library=lib_name, index_add_ms=index_add_ms, longest_segment=seg,
              longest_segment_chunks=chunks, mean_segment=B * K * N / (B * M),
              bound_ms=b_ms, bound_by=b_by))
    if not (ok and index_ok) or repro != 0.0:
        raise AssertionError(f'scatter disagrees (err {err}, index {index_ok}) or is not '
                             f'reproducible ({repro})')
    rows['scatter'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib_ms, library=lib_name, shape=shape,
                           inverse_index_ms=index_ms, index_add_ms=index_add_ms,
                           longest_segment=seg, longest_segment_chunks=chunks,
                           repeat_max_abs_diff=repro)
    # Its bf16 mode on the same rows; library: scatter_add_ of the rounded
    # rows (the rounding not timed).
    bf = torch.bfloat16
    idx = ki[..., :K].transpose(1, 2).reshape(B, K * N, 1).long().expand(B, K * N, C)
    src = t_attn.round_bf16(dg[:, :K].reshape(B, K * N, C))
    out_b = torch.zeros((B, M, C), device=dev)
    rows['scatter_bf16'] = bf16_sum_line(
        torch, 'scatter_bf16', lambda: t_attn.gather_bwd(ki, dg, M, K, bf),
        lambda: t_attn.gather_bwd_plain(ki, dg, M, K, bf),
        lambda: t_attn.gather_bwd(ki, dg, M, K),
        lambda: out_b.scatter_add_(1, idx, src), lib_name + ' of the bf16-rounded rows',
        b_ms, b_by, shape)
    del d1, d2, ref, dg, dg_rows, idx, src, out_b

    # The gathered interpolation's backward: a write pass over dg, held bit
    # for bit against its plain version (the same arithmetic in the same
    # order), zeros included; beside it the card's write ceiling for a
    # buffer of dg's size (dg.zero_() and o4d_fill16, a bare 16-byte store
    # loop, with and without evict-first stores) and the library call twice:
    # torch.mul into the zeroed buffer's row slice with the buffer and the
    # weights made outside the timing (the line PERF.md has carried since
    # the kernel's first port), and the whole function (zeroed buffer and
    # weights inside it).
    go = rand(B, N, E)
    o1 = t_attn.interp_g_bwd(kd, go, KI, K, E, 1e-4)
    o2 = t_attn.interp_g_bwd(kd, go, KI, K, E, 1e-4)
    ref = t_attn.interp_g_bwd_plain(kd, go, KI, K, E, 1e-4)
    torch.cuda.synchronize()
    err, scaled, ok = agree([(o1, ref)])
    bit_equal = bool(torch.equal(o1, ref))
    zeros_exact = bool(torch.equal(o1[:, KI:], ref[:, KI:])) and bool(
        torch.equal(o1[..., E:], ref[..., E:]))
    repro = max_err(o1, o2)
    ms = cuda_ms(torch, lambda: t_attn.interp_g_bwd(kd, go, KI, K, E, 1e-4), 20)
    plain_ms = cuda_ms(torch, lambda: t_attn.interp_g_bwd_plain(kd, go, KI, K, E, 1e-4), 5)
    lib_out = torch.zeros_like(ref)
    n_dg = lib_out.numel()
    ceiling = interp_g_bwd_write_times(torch, t_attn, kd, go, KI, E, lib_out, 20)
    lib_ms, lib_whole_ms = ceiling.pop('library_ms'), ceiling.pop('library_whole_ms')
    fill_ok = ceiling.pop('fill16_wrote_values')
    ceiling.update({k.replace('_ms', '_tb_s'): 4.0 * n_dg / v / 1e9
                    for k, v in list(ceiling.items())})
    b_ms, b_by = bound(4 * (B * N * KI + B * N * E + B * K * N * C), 1.0 * B * N * KI * E)
    shape = [B, N, KI, K, C]
    emit(dict(phase='kernel', name='interp_g_bwd', shape=shape,
              agree=ok and zeros_exact and bit_equal, bit_equal_to_plain=bit_equal,
              max_abs_err=err, max_scaled_err=scaled, tolerance='bit for bit',
              zero_rows_and_columns_exact=zeros_exact, repeat_max_abs_diff=repro, ms=ms,
              write_tb_s=4.0 * n_dg / ms / 1e9, plain_ms=plain_ms, library_ms=lib_ms,
              library='torch.mul of the normalised weights and go into the row slice (buffer '
                      'zeroed and weights normalised outside the timing)',
              library_whole_ms=lib_whole_ms,
              library_whole='torch.zeros + the weights + the same torch.mul, all timed',
              write_ceiling=dict(ceiling, buffer_bytes=4 * n_dg, fill16_wrote_values=fill_ok),
              bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
              parent_ms_perf_md=_PARENT_MS['interp_g_bwd']))
    if not (ok and zeros_exact and bit_equal and fill_ok) or repro != 0.0:
        raise AssertionError(f'interp_g_bwd disagrees (err {err}, bit-equal {bit_equal}, '
                             f'zeros {zeros_exact}), is not reproducible ({repro}) or the '
                             f'fill wrote wrong values ({fill_ok})')
    rows['interp_g_bwd'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=lib_ms, shape=shape,
                                library_whole_ms=lib_whole_ms, write_ceiling=ceiling,
                                repeat_max_abs_diff=repro)
    del o1, o2, ref, lib_out

    # The decoder route's backward of the gather and the interpolation: the
    # scatter of dg plus interp_bwd of go (gather_interp_bwd_split), against
    # its plain version, twice for the same bits; its time beside the
    # scatter's on the same rows.
    dg = rand(B, K, N, C)
    args = (ki, kd, dg, go, M, K, KI, 1e-4)
    f1 = t_attn.gather_interp_bwd_split(*args)
    f2 = t_attn.gather_interp_bwd_split(*args)
    ref = t_attn.gather_interp_bwd_plain(*args)
    torch.cuda.synchronize()
    err, scaled, ok = agree([(f1, ref)])
    repro = max_err(f1, f2)
    del f1, f2, ref
    route_ms = cuda_ms(torch, lambda: t_attn.gather_interp_bwd_split(*args), 20)
    scatter_ms = cuda_ms(torch, lambda: t_attn.gather_bwd(ki, dg, M, K), 20)
    emit(dict(phase='route', name='gather_interp_bwd', shape=[B, N, M, K, KI, C],
              agree=ok, max_abs_err=err, max_scaled_err=scaled, tolerance=tol,
              repeat_max_abs_diff=repro, ms=route_ms, scatter_same_rows_ms=scatter_ms,
              kernels='o4d_scatter + o4d_interp_bwd'))
    if not ok or repro != 0.0:
        raise AssertionError(f'the decoder route\'s gather + interpolation backward '
                             f'disagrees (err {err}) or is not reproducible ({repro})')
    rows['scatter']['route_ms'] = route_ms
    # PERF.md's write-bandwidth question: a write pass over dg's size into a
    # buffer held across calls, one that allocates each call, and a copy.
    buf = torch.empty_like(dg)
    nbytes = dg.numel() * 4
    fill_ms = cuda_ms(torch, lambda: buf.fill_(0.0), 20)
    zeros_ms = cuda_ms(torch, lambda: torch.zeros_like(dg), 20)
    copy_ms = cuda_ms(torch, lambda: buf.copy_(dg), 20)
    emit(dict(phase='write_probe', bytes=nbytes, fill_ms=fill_ms,
              fill_tb_s=nbytes / fill_ms / 1e9, zeros_ms=zeros_ms,
              zeros_tb_s=nbytes / zeros_ms / 1e9, copy_ms=copy_ms,
              copy_tb_s=2 * nbytes / copy_ms / 1e9))
    del buf, dg, args

    # The gathered attention's backward, and the per-row index route on the
    # same rows.
    q_proj, go = rand(B, N, D), rand(B, N, D)
    args = (qpos, q_proj, g, params, K, go)
    with torch.no_grad():
        dq, dgk, dw = t_attn.attn_g_bwd(*args)
        dq2, dgk2, dw2 = t_attn.attn_g_bwd(*args)
        iq, _, iw = t_attn.attn_bwd(qpos, q_proj, ki, pos2, feats2, params, K, False, go)
    rq, rg, rw = plain_per_example(torch, t_attn.attn_g_bwd_plain, args)
    torch.cuda.synchronize()
    err, scaled, ok = agree([(dq, rq), (dgk, rg)] + [(dw[n], rw[n]) for n in sorted(rw)])
    zeros_exact = bool(torch.equal(dgk[:, K:], rg[:, K:])) and bool(
        torch.equal(dgk[..., E:], rg[..., E:]))
    repro = max([max_err(dq, dq2), max_err(dgk, dgk2)] + [max_err(dw[n], dw2[n]) for n in dw])
    same_as_index = bool(torch.equal(dq, iq)) and all(bool(torch.equal(dw[n], iw[n]))
                                                       for n in iw)
    del rq, rg, rw, dq2, dgk2, dw2, iq, iw
    with torch.no_grad():
        ms = cuda_ms(torch, lambda: t_attn.attn_g_bwd(*args), 3)
        peak = launch_peak_gib(torch, lambda: t_attn.attn_g_bwd(*args))
        idx_ms = cuda_ms(torch, lambda: t_attn.attn_bwd(qpos, q_proj, ki, pos2, feats2,
                                                        params, K, False, go), 2)
    plain_ms = cuda_ms(torch, lambda: plain_per_example(torch, t_attn.attn_g_bwd_plain, args), 2)
    macs = B * N * K * ((3 * P + P * D + 2 * D * H + 2 * E * D)
                        + (4 * D * H + 2 * P * D + 3 * P + 4 * E * D))
    n_w = 3 * P + P + P * D + D + D * H + H + H * D + D + 2 * E * D
    nbytes = 4 * (B * N * (3 + D + D) + B * K * N * C + n_w
                  + B * N * D + B * K * N * C + n_w)
    b_ms, b_by = bound(nbytes, 2.0 * macs, _BF16_TC_FLOPS)
    f32_ms = bound(nbytes, 2.0 * macs)[0]
    rates = attn_rates(2.0 * macs, ms, b_ms)
    shape = [B, N, M, K, D, E]
    emit(dict(phase='kernel', name='attn_g_bwd', shape=shape, agree=ok and zeros_exact,
              max_abs_err=err, max_scaled_err=scaled, tolerance=tol,
              zero_rows_and_columns_exact=zeros_exact, repeat_max_abs_diff=repro,
              dq_and_weight_grads_equal_index_route=same_as_index, ms=ms,
              plain_ms=plain_ms, plain='autograd through attn_g_plain, one example at a time',
              library_ms=None, index_route_per_row_bwd_ms=idx_ms, bound_ms=b_ms,
              bound_by=b_by, bound_peak='bf16 tensor core 989 TFLOP/s',
              bound_f32_cuda_core_ms=f32_ms, flop=2.0 * macs, launch_peak_gib=peak,
              **rates))
    if not (ok and zeros_exact and same_as_index) or repro != 0.0:
        raise AssertionError(f'attn_g_bwd disagrees (err {err}, zeros {zeros_exact}, '
                             f'index route {same_as_index}) or is not reproducible ({repro})')
    rows['attn_g_bwd'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=None,
                              bound_peak='bf16 tensor core 989 TFLOP/s',
                              bound_f32_cuda_core_ms=f32_ms, shape=shape,
                              repeat_max_abs_diff=repro, index_route_per_row_bwd_ms=idx_ms,
                              launch_peak_gib=peak, **rates)

    # The bf16 mode (fused_decoder_dtype='bf16') over the bf16 gather's rows,
    # and the per-row index route's bf16 kernel on the same rows.
    bf = torch.bfloat16
    g_bf = t_attn.knn_gather_rows(pos2, feats2, knn, K, compute_dtype=bf)
    args = (qpos, q_proj, g_bf, params, K, go)
    iq, _, iw = t_attn.attn_bwd(qpos, q_proj, ki, pos2, feats2, params, K, False, go, bf)

    def gathered_rows(b, n0, n1):
        r = g_bf[b, :K, n0:n1].transpose(0, 1).reshape(-1, C)
        return qpos[b, n0:n1, None, :].expand(-1, K, -1).reshape(-1, 3) - r[:, E:], r[:, :E]
    rows['attn_g_bwd_bf16'], _, _ = attn_bwd_bf16_line(
        torch, t_attn, 'attn_g_bwd_bf16', lambda: t_attn.attn_g_bwd(*args, bf),
        lambda: t_attn.attn_g_bwd_plain(*args, bf),
        lambda: t_attn.attn_g_bwd(*args), (q_proj, gathered_rows), params, K, False,
        (D, E, H, P), macs, nbytes, shape, ms, same_as=(iq, iw))
    del g_bf, iq, iw


def sattn_bf16_line(torch, t_sattn, t_attn, name, q, gf, rel, params, K, go, f32, work):
    """The bf16 mode of the fused self-attention (mixed_precision) at one
    block: sattn_bf16 against sattn_plain in bf16 (bf16_agree's gate) and
    sattn_bwd_bf16 against sattn_bwd_plain in bf16 (each gradient within
    _ATTN_GATE), on the same inputs, gf rounded to bf16 as the operator hands
    it over; the backward twice for the same bits, dgf and the weight
    kernels' gradients bf16 values; the f32 kernels' distance from the plain
    bf16 versions (the gates must reject them); times beside the f32
    kernels' of the same call (f32: their ms). work: (f_bytes, f_macs,
    b_bytes, b_macs)."""
    BF = torch.bfloat16
    f_bytes, f_macs, b_bytes, b_macs = work
    with torch.no_grad():
        gfb = t_attn.round_bf16(gf)
        fwd = lambda: t_sattn.fused_gathered_attention(q, gfb, rel, params, K,  # noqa: E731
                                                       compute_dtype=BF)
        out, ref = fwd(), t_sattn.sattn_plain(q, gfb, rel, params, BF)
        out32 = t_sattn.fused_gathered_attention(q, gf, rel, params, K)
        torch.cuda.synchronize()
        f_ok, f_err, f_rel = bf16_agree(out, ref), max_err(out, ref), rel_l2(out, ref)
        f32_f_rel, f32_f_ok = rel_l2(out32, ref), bf16_agree(out32, ref)
        del out, ref, out32
        bwd = lambda: t_sattn.sattn_bwd(q, gfb, rel, params, K, go, BF)  # noqa: E731
        dq, dgf, dw = bwd()
        dq2, dgf2, dw2 = bwd()
        rq, rgf, rw = t_sattn.sattn_bwd_plain(q, gfb, rel, params, go, BF)
        torch.cuda.synchronize()
        names = [('dq',), ('dgf',)] + sorted(rw)
        ref_list = [rq, rgf] + [rw[n] for n in sorted(rw)]
        triples = list(zip(names, [dq, dgf] + [dw[n] for n in sorted(rw)], ref_list))
        b_ok, b_worst, b_err = bf16_grads_agree(triples, _ATTN_GATE)
        each = bf16_grads_each(triples)
        repro = max([max_err(dq, dq2), max_err(dgf, dgf2)]
                    + [max_err(dw[n], dw2[n]) for n in dw])
        rounded = bool(torch.equal(dgf, t_attn.round_bf16(dgf))) and all(
            bool(torch.equal(dw[n], t_attn.round_bf16(dw[n]))) for n in dw if n[1] == 'kernel')
        del triples, dq, dgf, dw, dq2, dgf2, dw2
        fq, fgf, fw = t_sattn.sattn_bwd(q, gf, rel, params, K, go)
        f32_triples = list(zip(names, [fq, fgf] + [fw[n] for n in sorted(rw)], ref_list))
        f32_b_ok, f32_b_worst, _ = bf16_grads_agree(f32_triples, _ATTN_GATE)
        f32_each = bf16_grads_each(f32_triples)
        del f32_triples, fq, fgf, fw, rq, rgf, rw, ref_list
        ms = cuda_ms(torch, fwd, 5)
        plain_ms = cuda_ms(torch, lambda: t_sattn.sattn_plain(q, gfb, rel, params, BF), 3)
        b_ms = cuda_ms(torch, bwd, 3)
        b_plain_ms = cuda_ms(torch, lambda: t_sattn.sattn_bwd_plain(q, gfb, rel, params, go,
                                                                     BF), 2)
    fb_ms, fb_by = bound(f_bytes, 2.0 * f_macs, _BF16_TC_FLOPS)
    bb_ms, bb_by = bound(b_bytes, 2.0 * b_macs, _BF16_TC_FLOPS)
    line = dict(name=name, fwd_agree=f_ok, fwd_max_abs_err=f_err, fwd_rel_l2=f_rel,
                f32_kernel_fwd_rel_l2_vs_plain=f32_f_rel, f32_kernel_fwd_within_gate=f32_f_ok,
                bwd_agree=b_ok, bwd_rel_l2_worst=b_worst, bwd_max_abs_err=b_err,
                bwd_rel_l2_each=each, f32_kernel_bwd_rel_l2_worst=f32_b_worst,
                f32_kernel_bwd_rel_l2_each=f32_each, f32_kernel_bwd_within_gate=f32_b_ok,
                bwd_repeat_max_abs_diff=repro, dgf_and_weight_kernel_grads_are_bf16=rounded,
                fwd_ms=ms, fwd_plain_ms=plain_ms, f32_fwd_ms=f32[0], bwd_ms=b_ms,
                bwd_plain_ms=b_plain_ms, f32_bwd_ms=f32[1], fwd_bound_ms=fb_ms,
                fwd_bound_by=fb_by, fwd_share_of_bound=fb_ms / ms, bwd_bound_ms=bb_ms,
                bwd_bound_by=bb_by, bwd_share_of_bound=bb_ms / b_ms)
    ok = (f_ok and b_ok and repro == 0.0 and rounded and not f32_f_ok and not f32_b_ok)
    emit(dict(phase='kernel', kernel='sattn_bf16+sattn_bwd_bf16', agree=ok,
              tolerance=f'forward {_BF16_TOL}; backward {bf16_tol(_ATTN_GATE)}',
              plain='sattn_plain / sattn_bwd_plain with compute_dtype=torch.bfloat16', **line))
    if not ok:
        raise AssertionError(f'sattn_bf16 at {name} disagrees (fwd {f_rel}, bwd {b_worst}), '
                             f'is not reproducible ({repro}), its gradients are not bf16 '
                             f'({rounded}), or the f32 kernels pass its gates '
                             f'({f32_f_rel}, {f32_b_worst})')
    return line


def check_self_attention_kernels(torch, dev, rng, encoder, rows):
    """sattn and sattn_bwd at the encoder's four self-attention blocks of the
    gv1 train step (B 3: 14336 / 4779 / 1593 / 531 queries at D 36 / 72 /
    144 / 288, each with that block's seeded weights) and at the n57344
    step's first block (B 1, 57344 x 16 x 36), on neighbours from the kNN
    kernel: each against its plain version, the backward twice for the same
    bits. Beside them the block's chain (the 'auto' path after the kNN:
    project, gather, MLPs, softmax) and the fused route (gather + sattn;
    backward sattn_bwd + scatter), forward and forward + backward. Then the
    bf16 mode on the same inputs (sattn_bf16_line). The kernels lines carry
    the sums over the four gv1 blocks (one step's launches)."""
    import importlib
    t_sattn = importlib.import_module('occlusions4d_torch.ops.self_attention')
    t_attn = importlib.import_module('occlusions4d_torch.ops.attention')
    t_knn = importlib.import_module('occlusions4d_torch.ops.knn')
    K, P = 16, 32
    tol = 'forward atol 1e-4, rtol 1e-3; backward atol 1e-4 x max(1, max|plain|), rtol 1e-3'
    per, per_bf16 = [], []
    for name, B, N, blk in _SATTN_SHAPES:
        att = encoder.blocks[blk].layer2
        D = E = att.dim
        H = 2 * D
        params = {n: {leaf: t.detach().contiguous() for leaf, t in d.items()}
                  for n, d in att.kernel_params().items()}

        def rand(*shape, scale=None):
            a = rng.rand(*shape) * scale - scale / 2 if scale else rng.randn(*shape)
            return torch.tensor(a.astype(np.float32), device=dev)
        pos, x, q, go = rand(B, N, 3, scale=4.0), rand(B, N, D), rand(B, N, D), rand(B, N, D)
        _, idx = t_knn.knn(pos, pos, K)
        with torch.no_grad():
            gf = t_attn.gather_rows(x, idx)
            rel = (pos[:, :, None] - t_knn.gather_neighbors(pos, idx)).contiguous()
            out = t_sattn.fused_gathered_attention(q, gf, rel, params, K)
            ref = t_sattn.sattn_plain(q, gf, rel, params)
            torch.cuda.synchronize()
            f_err = max_err(out, ref)
            f_ok = bool(torch.allclose(out, ref, atol=1e-4, rtol=1e-3))
            del out, ref
            bwd = lambda: t_sattn.sattn_bwd(q, gf, rel, params, K, go)  # noqa: E731
            dq, dgf, dw = bwd()
            dq2, dgf2, dw2 = bwd()
            rq, rgf, rw = t_sattn.sattn_bwd_plain(q, gf, rel, params, go)
            torch.cuda.synchronize()
            pairs = [(dq, rq), (dgf, rgf)] + [(dw[n], rw[n]) for n in sorted(rw)]
            b_err = max(max_err(a, b) for a, b in pairs)
            b_scaled = max(max_err(a, b) / max(1.0, float(b.abs().max())) for a, b in pairs)
            b_ok = len(rw) == 10 and all(
                bool(torch.allclose(a, b, atol=1e-4 * max(1.0, float(b.abs().max())),
                                    rtol=1e-3)) for a, b in pairs)
            repro = max([max_err(dq, dq2), max_err(dgf, dgf2)]
                        + [max_err(dw[n], dw2[n]) for n in dw])
            del dq, dgf, dw, dq2, dgf2, dw2, rq, rgf, rw
            f_ms = cuda_ms(torch, lambda: t_sattn.fused_gathered_attention(
                q, gf, rel, params, K), 5)
            f_plain_ms = cuda_ms(torch, lambda: t_sattn.sattn_plain(q, gf, rel, params), 3)
            f_peak = launch_peak_gib(torch, lambda: t_sattn.fused_gathered_attention(
                q, gf, rel, params, K))
            b_ms = cuda_ms(torch, bwd, 3)
            b_plain_ms = cuda_ms(torch, lambda: t_sattn.sattn_bwd_plain(
                q, gf, rel, params, go), 2)

        def chain(qq, xx, p):
            '''The module's 'auto' path after the kNN (models/layers.py).'''
            kk = t_knn.gather_neighbors(xx @ p['to_k']['kernel'], idx)
            vv = t_knn.gather_neighbors(xx @ p['to_v']['kernel'], idx)
            pe = torch.relu(rel @ p['pos_mlp_0']['kernel'] + p['pos_mlp_0']['bias'])
            pe = pe @ p['pos_mlp_2']['kernel'] + p['pos_mlp_2']['bias']
            a = torch.relu((qq[:, :, None] - kk + pe) @ p['attn_mlp_0']['kernel']
                           + p['attn_mlp_0']['bias'])
            a = a @ p['attn_mlp_2']['kernel'] + p['attn_mlp_2']['bias']
            att_w = torch.softmax(a / math.sqrt(D), dim=-2)
            return torch.einsum('bnkd,bnkd->bnd', att_w, vv + pe)

        def fused(qq, xx, p):
            return t_sattn.fused_gathered_attention(qq, t_attn.gather_rows(xx, idx), rel, p, K)

        def fwd_bwd(fn):
            qq, xx = q.detach().requires_grad_(True), x.detach().requires_grad_(True)
            p = {n: {leaf: t.detach().requires_grad_(True) for leaf, t in d.items()}
                 for n, d in params.items()}
            leaves = [t for d in p.values() for t in d.values()]
            torch.autograd.grad(fn(qq, xx, p), [qq, xx] + leaves, go)
        with torch.no_grad():
            chain_ms = cuda_ms(torch, lambda: chain(q, x, params), 3)
            route_ms = cuda_ms(torch, lambda: fused(q, x, params), 3)
        chain_fb_ms = cuda_ms(torch, lambda: fwd_bwd(chain), 2)
        route_fb_ms = cuda_ms(torch, lambda: fwd_bwd(fused), 2)
        rows_n = B * N * K
        n_w = 2 * E * D + 3 * P + P + P * D + D + D * H + H + H * D + D
        f_macs = rows_n * (2 * E * D + 3 * P + P * D + 2 * D * H)
        b_macs = f_macs + rows_n * (4 * D * H + 2 * P * D + 3 * P + 4 * E * D)
        f_bytes = 4 * (B * N * D + rows_n * (E + 3) + n_w + B * N * D)
        b_bytes = 4 * (2 * B * N * D + rows_n * (E + 3) + n_w + B * N * D + rows_n * E + n_w)
        fb_ms, fb_by = bound(f_bytes, 2.0 * f_macs, _BF16_TC_FLOPS)
        bb_ms, bb_by = bound(b_bytes, 2.0 * b_macs, _BF16_TC_FLOPS)
        line = dict(name=name, shape=[B, N, K, D, E], fwd_max_abs_err=f_err, fwd_agree=f_ok,
                    bwd_max_abs_err=b_err, bwd_max_scaled_err=b_scaled, bwd_agree=b_ok,
                    bwd_repeat_max_abs_diff=repro, fwd_ms=f_ms, fwd_plain_ms=f_plain_ms,
                    fwd_launch_peak_gib=f_peak,
                    bwd_ms=b_ms, bwd_plain_ms=b_plain_ms, chain_fwd_ms=chain_ms,
                    fused_route_fwd_ms=route_ms, chain_fwd_bwd_ms=chain_fb_ms,
                    fused_route_fwd_bwd_ms=route_fb_ms, fwd_bound_ms=fb_ms,
                    fwd_bound_by=fb_by, bwd_bound_ms=bb_ms, bwd_bound_by=bb_by,
                    fwd_bound_f32_cuda_core_ms=bound(f_bytes, 2.0 * f_macs)[0],
                    bwd_bound_f32_cuda_core_ms=bound(b_bytes, 2.0 * b_macs)[0],
                    fwd_flop=2.0 * f_macs, bwd_flop=2.0 * b_macs)
        emit(dict(phase='kernel', kernel='sattn+sattn_bwd', tolerance=tol, **line))
        if not (f_ok and b_ok) or repro != 0.0:
            raise AssertionError(f'sattn at {name} disagrees (fwd {f_err}, bwd {b_err}) or '
                                 f'its backward is not reproducible ({repro})')
        per.append(line)
        per_bf16.append(sattn_bf16_line(torch, t_sattn, t_attn, name, q, gf, rel, params, K,
                                        go, (f_ms, b_ms), (f_bytes, f_macs, b_bytes, b_macs)))
        del gf, rel, x, q, go, pos, idx

    gv1 = [p for p in per if p['name'].startswith('gv1')]
    total = lambda key: sum(p[key] for p in gv1)  # noqa: E731
    common = dict(library_ms=None, bound_peak='bf16 tensor core 989 TFLOP/s',
                  sums_over='the four gv1 train-step blocks (B 3), one launch each')
    rows['sattn'] = dict(max_abs_err=max(p['fwd_max_abs_err'] for p in per),
                         ms=total('fwd_ms'), plain_ms=total('fwd_plain_ms'),
                         bound_ms=total('fwd_bound_ms'), bound_by='operations',
                         bound_f32_cuda_core_ms=total('fwd_bound_f32_cuda_core_ms'),
                         chain_ms=total('chain_fwd_ms'), per_block_ms=[p['fwd_ms'] for p in gv1],
                         n57344_l0_ms=[p['fwd_ms'] for p in per if p['name'].startswith(
                             'n57344')][0], **common)
    rows['sattn_bwd'] = dict(max_abs_err=max(p['bwd_max_abs_err'] for p in per),
                             ms=total('bwd_ms'), plain_ms=total('bwd_plain_ms'),
                             bound_ms=total('bwd_bound_ms'), bound_by='operations',
                             bound_f32_cuda_core_ms=total('bwd_bound_f32_cuda_core_ms'),
                             chain_fwd_bwd_ms=total('chain_fwd_bwd_ms'),
                             fused_route_fwd_bwd_ms=total('fused_route_fwd_bwd_ms'),
                             repeat_max_abs_diff=max(p['bwd_repeat_max_abs_diff']
                                                     for p in per), **common)
    gv1_b = [p for p in per_bf16 if p['name'].startswith('gv1')]
    total_b = lambda key: sum(p[key] for p in gv1_b)  # noqa: E731
    n57_b = [p for p in per_bf16 if p['name'].startswith('n57344')]
    rows['sattn_bf16'] = dict(
        max_abs_err=max(p['fwd_max_abs_err'] for p in per_bf16), ms=total_b('fwd_ms'),
        plain_ms=total_b('fwd_plain_ms'), bound_ms=total_b('fwd_bound_ms'),
        bound_by='operations', f32_kernel_ms=total_b('f32_fwd_ms'),
        rel_l2_err=max(p['fwd_rel_l2'] for p in per_bf16),
        f32_kernel_rel_l2_vs_plain=min(p['f32_kernel_fwd_rel_l2_vs_plain'] for p in per_bf16),
        per_block_ms=[p['fwd_ms'] for p in gv1_b], n57344_l0_ms=n57_b[0]['fwd_ms'], **common)
    # The forward sums beside the parent's figures from PERF.md (on this
    # line only: the kernels line carries what this run measured).
    emit(dict(phase='sattn_forward_sums', sums_over=common['sums_over'],
              sattn_ms=rows['sattn']['ms'], sattn_parent_ms_perf_md=_PARENT_MS['sattn'],
              sattn_bf16_ms=rows['sattn_bf16']['ms'],
              sattn_bf16_parent_ms_perf_md=_PARENT_MS['sattn_bf16']))
    rows['sattn_bwd_bf16'] = dict(
        max_abs_err=max(p['bwd_max_abs_err'] for p in per_bf16), ms=total_b('bwd_ms'),
        plain_ms=total_b('bwd_plain_ms'), bound_ms=total_b('bwd_bound_ms'),
        bound_by='operations', f32_kernel_ms=total_b('f32_bwd_ms'),
        rel_l2_err=max(p['bwd_rel_l2_worst'] for p in per_bf16),
        f32_kernel_rel_l2_vs_plain=min(p['f32_kernel_bwd_rel_l2_worst'] for p in per_bf16),
        repeat_max_abs_diff=max(p['bwd_repeat_max_abs_diff'] for p in per_bf16),
        per_block_ms=[p['bwd_ms'] for p in gv1_b], n57344_l0_ms=n57_b[0]['bwd_ms'],
        **common)


def sampler_like(torch, t_knn, dev, rng, B, N, M):
    """The sampler's air rejection search (sampler/guided.py:236-239): keys
    uniform in the gv1 cube (z >= 0), about 20% masked; candidates drawn
    from the keys and jittered 0.2 to 0.6 (r to 3 r) in a random direction.
    :return the pruned entry's (q, keys, |k|^2 with +inf masked)."""
    k = rng.rand(B, M, 3).astype(np.float32) * 10 - 5
    k[..., 2] = np.abs(k[..., 2])
    u = rng.randn(B, N, 3)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    q = (np.take_along_axis(k, rng.randint(0, M, (B, N))[..., None], 1)
         + u * (0.2 + 0.4 * rng.rand(B, N, 1))).astype(np.float32)
    mask = torch.tensor(rng.rand(B, M) > 0.2, device=dev)
    return t_knn._prepare(torch.tensor(q, device=dev), torch.tensor(k, device=dev), mask)[:3]


def knn_pruned_line(torch, t_knn, dev, case, q, kk, kn, K, same):
    """One pruned-entry line: the result against the plain version and the
    brute-force kernel (exact: distances and indices), its time with the
    preparation (ms), the preparation alone (sort_and_boxes_ms: box, codes,
    sorts, arrangement), the brute kernel's time, the library's
    (torch.cdist and torch.topk), the share of (query tile, key block) pairs
    processed, and its bound: each input read once, each output written
    once, one distance per output neighbour, or, where larger, the
    operations of the (query, key) pairs in the visited (query tile, key
    block) pairs at 8 f32 instructions a pair. :return the {"kernels"} row."""
    B, N, M = q.shape[0], q.shape[1], kk.shape[1]
    visited = torch.zeros(1, dtype=torch.int32, device=dev)
    d_k, i_k = t_knn._pruned_cuda(q, kk, kn, K, same, visited=visited)
    d_b, i_b = t_knn.knn_rank(q, kk, kn, K)
    d_p, i_p = t_knn.knn_rank_plain(q, kk, kn, K)
    torch.cuda.synchronize()
    n_diff, n_bad = knn_agree(d_k, i_k, d_p, i_p)
    err = float((d_k - d_p).abs().max())
    exact = bool(torch.equal(d_k, d_p) and torch.equal(i_k, i_p)
                 and torch.equal(d_b, d_p) and torch.equal(i_b, i_p))
    del d_b, i_b, d_p, i_p
    lib = t_knn._pruned_lib()
    pairs = B * -(-N // lib.o4d_knn_prune_tile()) * -(-M // lib.o4d_knn_prune_block())
    ms = cuda_ms(torch, lambda: t_knn._pruned_cuda(q, kk, kn, K, same), 10)
    prep_ms = cuda_ms(torch, lambda: t_knn.pruned_prepare_cuda(q, kk, kn, same), 10)
    brute_ms = cuda_ms(torch, lambda: t_knn.knn_rank(q, kk, kn, K), 5)
    plain_ms = cuda_ms(torch, lambda: t_knn.knn_rank_plain(q, kk, kn, K), 1)
    lib_ms = cuda_ms(torch, lambda: torch.topk(torch.cdist(q, kk), K, largest=False), 1)
    out_ms, out_by = bound(B * (N * 3 * 4 + M * 4 * 4) + B * N * K * 8, 7.0 * B * N * K)
    # The work this run's data needs: every (query, key) pair of the
    # (query tile, key block) pairs the kernel visited, at the brute kernel's
    # 8 f32 instructions a pair on the CUDA cores.
    point_pairs = int(visited) * lib.o4d_knn_prune_tile() * lib.o4d_knn_prune_block()
    visited_ms = 8.0 * point_pairs / _CUDA_CORE_IPS * 1e3
    b_ms, b_by = max((out_ms, out_by), (visited_ms, 'operations'))
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               bound_uses='max(outputs bound, visited pairs x 8 instructions / 33.5 T/s)',
               output_bound_ms=out_ms, output_bound_by=out_by,
               visited_pairs_bound_ms=visited_ms, visited_point_pairs=point_pairs,
               library_ms=lib_ms, library='torch.cdist + torch.topk', shape=[B, N, M, K],
               brute_kernel_ms=brute_ms, sort_and_boxes_ms=prep_ms,
               processed_share=int(visited) / pairs)
    emit(dict(phase='kernel', name='knn_pruned', case=case, agree=exact,
              index_mismatches=n_diff, tolerance='exact (distances and indices)', **row))
    if not exact or n_bad:
        raise AssertionError(f'knn_pruned {case} disagrees: {n_bad} mismatches, err {err}')
    return row


def entry_ms(torch, lib, name, args, reps):
    """ms per launch of the C entry `name` of a kernel library on prebuilt
    operands (tensors passed as pointers, Python floats as float, ints as
    int, then the current stream), between CUDA events: the kernel without
    its Python wrapper's host work, which the wrapper's own timing includes
    once the kernel is shorter than it."""
    conv, types = [], []
    for a in args:
        if isinstance(a, torch.Tensor):
            conv.append(ctypes.c_void_p(a.data_ptr()))
            types.append(ctypes.c_void_p)
        elif isinstance(a, float):
            conv.append(ctypes.c_float(a))
            types.append(ctypes.c_float)
        else:
            conv.append(ctypes.c_int(a))
            types.append(ctypes.c_int)
    fn = getattr(lib, name)
    fn.argtypes = types + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def call():
        rc = fn(*conv, stream)
        if rc != 0:
            raise RuntimeError(f'{name} failed to launch: cudaError {rc}')
    return cuda_ms(torch, call, reps)


# The brute kNN's lines (name, B, N, M, K, queries): 'keys' queries the
# first N keys (the encoder's searches: FPS picks among the keys), 'grid' a
# chunk of grid_points_numpy's order over the keys' cube (the engine's
# stream), 'random' a uniform cloud over it. The encoder's two searches the
# brute entry still runs (531 x 1593 K12, 531^2 K16) at B 1 (a scene) and B 3
# (a train step); the decoder's per-chunk search at gv1's and cv1's M in
# both query orders; the train frames' searches.
_KNN_BRUTE_CASES = [
    ('enc_4779x14336_k12', 1, 4779, 14336, 12, 'keys'),
    ('enc_4779x4779_k16', 1, 4779, 4779, 16, 'keys'),
    ('enc_1593x4779_k12', 1, 1593, 4779, 12, 'keys'),
    ('enc_1593x1593_k16', 1, 1593, 1593, 16, 'keys'),
    ('enc_531x1593_k12', 1, 531, 1593, 12, 'keys'),
    ('enc_531x531_k16', 1, 531, 531, 16, 'keys'),
    ('enc_531x1593_k12_b3', 3, 531, 1593, 12, 'keys'),
    ('enc_531x531_k16_b3', 3, 531, 531, 16, 'keys'),
    ('dec_gv1_chunk_random', 1, _CHUNK, 531, 14, 'random'),
    ('dec_gv1_chunk_grid', 1, _CHUNK, 531, 14, 'grid'),
    ('dec_cv1_chunk_random', 1, _CHUNK, _CV1_M, 14, 'random'),
    ('dec_cv1_chunk_grid', 1, _CHUNK, _CV1_M, 14, 'grid'),
    ('dec_gv1_train_frame', 3, 17920, 531, 14, 'random'),
    ('dec_cv1_train_frame', 3, _CV1_N, _CV1_M, 14, 'random'),
]


def grid_chunk(n, b=1):
    """(b, n, 3) queries: the eighth 32768-query chunk of the dense grid over
    the cube [-5, 5]^3, in grid_points_numpy's order (x-major, z fastest),
    as the engine streams a scene's queries."""
    from occlusions4d_torch.ops.bounds import Cuboid
    from occlusions4d_torch.ops.sampling import grid_points_numpy
    grid = grid_points_numpy(_NUM_SAMPLE, Cuboid(-5.0, 5.0, -5.0, 5.0, -5.0, 5.0))
    return np.broadcast_to(grid[7 * _CHUNK:7 * _CHUNK + n], (b, n, 3)).astype(np.float32)


def knn_brute_line(torch, t_knn, lib, case, q, kk, kn, K):
    """One brute-kNN line: the wrapper's result against the plain version
    (distances and indices; the gate: no index mismatch outside a tie within
    an ulp, and equal distances), the wrapper's time (ms), the C entry's on
    prebuilt rows (entry_ms) and, where the tree has brute_lanes, at 16 and
    32 lanes (entry_ms_by_lanes, each result against the plain version
    too), the plain version's and the library's (cdist + stable sort), the
    parent's wrapper and entry times from PERF.md (_PARENT_MS,
    _PARENT_ENTRY_MS), and the bound: the larger of the bytes (each input
    read once, each output written once) over the HBM rate and 8 f32
    instructions per (query, key) pair (7 separately rounded products and
    sums under -fmad=false, and a compare) over the CUDA cores' rate; the
    old figure, 7 FLOP a pair at the FMA rate, beside it.
    :return the {"kernels"} row."""
    B, N, _ = q.shape
    M = kk.shape[1]
    d_k, i_k = t_knn.knn_rank(q, kk, kn, K)
    d_p, i_p = t_knn.knn_rank_plain(q, kk, kn, K)
    torch.cuda.synchronize()
    n_diff, n_bad = knn_agree(d_k, i_k, d_p, i_p)
    err = float((d_k - d_p).abs().max())
    exact = bool(torch.equal(d_k, d_p)) and bool(torch.equal(i_k, i_p))
    ok = n_bad == 0 and err == 0.0
    keys4 = torch.cat([kk, kn[..., None]], -1).contiguous()
    out_d, out_i = torch.empty_like(d_k), torch.empty_like(i_k)
    args = [q, keys4, out_d, out_i, B, N, M, K]
    extra = {}
    lanes = getattr(t_knn, 'brute_lanes', None)  # None: an older tree's entry.
    if lanes is None:
        e_ms = entry_ms(torch, lib, 'o4d_knn_brute', args, 20)
    else:
        extra['lanes'] = lanes(B, N)
        e_ms = entry_ms(torch, lib, 'o4d_knn_brute', args + [extra['lanes']], 20)
        # Both lane counts, each result held to the plain version.
        extra['entry_ms_by_lanes'], exact_l = {}, True
        for L in (16, 32):
            extra['entry_ms_by_lanes'][L] = entry_ms(torch, lib, 'o4d_knn_brute', args + [L], 5)
            torch.cuda.synchronize()
            exact_l = exact_l and bool(torch.equal(out_d, d_p)) and bool(torch.equal(out_i, i_p))
        extra['every_lane_count_exact'] = exact_l
        ok = ok and exact_l
    del d_k, i_k
    ms = cuda_ms(torch, lambda: t_knn.knn_rank(q, kk, kn, K), 20)
    plain_ms = cuda_ms(torch, lambda: t_knn.knn_rank_plain(q, kk, kn, K), 2)
    lib_ms = cuda_ms(torch, lambda: torch.sort(torch.cdist(q, kk), dim=-1,
                                               stable=True)[0][..., :K], 2)
    pairs = B * N * M
    b_ms, b_by = bound((B * N * 3 + B * M * 4) * 4 + B * N * K * 8, 8.0 * pairs,
                       _CUDA_CORE_IPS)
    parent = _PARENT_MS.get(f'knn_brute:{case}')
    parent_e = _PARENT_ENTRY_MS.get(f'knn_brute:{case}')
    row = dict(max_abs_err=err, ms=ms, entry_ms=e_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib_ms, shape=[B, N, M, K])
    emit(dict(phase='kernel', name='knn_brute', case=case, agree=ok, exact=exact,
              index_mismatches=n_diff, tolerance='exact (distances and indices)',
              share_of_bound=b_ms / ms, entry_share_of_bound=b_ms / e_ms,
              bound_fma_rate_ms=7.0 * pairs / _F32_FLOPS * 1e3,
              parent_ms_perf_md=parent, parent_over_ms=None if parent is None
              else parent / ms, parent_entry_ms_perf_md=parent_e,
              parent_entry_over_entry_ms=None if parent_e is None else parent_e / e_ms,
              library='torch.cdist + stable torch.sort', **row, **extra))
    if not ok:
        raise AssertionError(f'knn_brute {case} disagrees: {n_bad} untied index '
                             f'mismatches, err {err}, {extra}')
    return row, (d_p, i_p, keys4)


def knn_brute_inputs(torch, t_knn, dev):
    """(case, q, kk, kn, K) of each _KNN_BRUTE_CASES line: seeded clouds in
    [-5, 5]^3, prepared as knn_rank takes them."""
    rng = np.random.RandomState(31)
    for case, B, N, M, K, order in _KNN_BRUTE_CASES:
        keys = torch.tensor(rng.rand(B, M, 3).astype(np.float32) * 10 - 5, device=dev)
        if order == 'keys':
            qs = keys[:, :N]
        elif order == 'grid':
            qs = torch.tensor(grid_chunk(N, B), device=dev)
        else:
            qs = torch.tensor(rng.rand(B, N, 3).astype(np.float32) * 10 - 5, device=dev)
        yield (case,) + tuple(t_knn._prepare(qs, keys, None)[:3]) + (K,)


def knn_brute_lines(torch, t_knn, dev, rows, each=None):
    """The K1 lines of _KNN_BRUTE_CASES (knn_brute_inputs); the gv1 decoder
    chunk with random queries gives the {"kernels"} row (the shape of the
    earlier PRs' rows). each(case, q, kk, kn, K, plain d, plain i, keys4),
    where given, runs after each line on its inputs."""
    from occlusions4d_torch.ops import _build
    lib = _build.library('knn')
    for case, q, kk, kn, K in knn_brute_inputs(torch, t_knn, dev):
        row, (d_p, i_p, keys4) = knn_brute_line(torch, t_knn, lib, case, q, kk, kn, K)
        if each is not None:
            each(case, q, kk, kn, K, d_p, i_p, keys4)
        if case == 'dec_gv1_chunk_random':
            rows['knn_brute'] = row


def interp_entry_ms(torch, t_attn, name, ki, kd, feats, k, reps=20):
    """ms per launch of o4d_<name> (interp, interp_bf16) on prebuilt
    operands (entry_ms)."""
    B, N, KS = ki.shape
    M, E = feats.shape[1:]
    out = torch.empty((B, N, E), dtype=torch.float32, device=feats.device)
    return entry_ms(torch, t_attn._build.library('interp'), f'o4d_{name}',
                    [ki, kd, feats, out, B, N, M, E, KS, k, 1e-4], reps)


def interp_g_entry_ms(torch, t_attn, name, kd, g, k, reps=20):
    """ms per launch of o4d_<name> (interp_g, interp_g_bf16) on prebuilt
    operands (entry_ms)."""
    B, KE, N, C = g.shape
    out = torch.empty((B, N, C - 3), dtype=torch.float32, device=g.device)
    return entry_ms(torch, t_attn._build.library('interp'), f'o4d_{name}',
                    [kd, g, out, B, N, C - 3, kd.shape[2], KE, k, 1e-4], reps)


def interp_grid_line(torch, t_attn, dev, pos2, feats2):
    """The index-route interpolation (f32 and bf16) at the gv1 decode chunk
    with grid-ordered queries (grid_chunk), whose neighbouring queries share
    most of their rows: each mode against its plain version (atol 1e-5,
    rtol 1e-5), its wrapper's time (ms) and its C entry's (entry_ms) beside
    the parent's entry time (_PARENT_ENTRY_MS)."""
    qg = torch.tensor(grid_chunk(_CHUNK), device=dev)
    ki, kd = t_attn.knn_extract(qg, pos2, 14)
    res = {}
    for name, cd in (('interp', torch.float32), ('interp_bf16', torch.bfloat16)):
        call = lambda: t_attn.fused_knn_interp(qg, pos2, feats2, 8, knn=(ki, kd),  # noqa: E731
                                               compute_dtype=cd)
        o_k = call()
        o_p = t_attn.interp_plain(ki, kd, feats2, 8, 1e-4, cd)
        torch.cuda.synchronize()
        ok = bool(torch.allclose(o_k, o_p, atol=1e-5, rtol=1e-5))
        e_ms = interp_entry_ms(torch, t_attn, name, ki, kd, feats2, 8)
        parent_e = _PARENT_ENTRY_MS.get(f'{name}:grid')
        res[name] = dict(agree=ok, max_abs_err=max_err(o_k, o_p), ms=cuda_ms(torch, call, 20),
                         entry_ms=e_ms, parent_entry_ms_perf_md=parent_e,
                         parent_entry_over_entry_ms=None if parent_e is None
                         else parent_e / e_ms)
        if not ok:
            raise AssertionError(f'{name} disagrees on grid-ordered queries')
    emit(dict(phase='kernel_grid', name='interp', shape=[_CHUNK, 531, 8, feats2.shape[-1]],
              queries='grid_chunk', tolerance='atol 1e-5, rtol 1e-5', **res))
    return res


def knn_crossover_line(torch, t_knn, dev, rng):
    """The brute/pruned crossover (ops/knn.py PRUNED_MIN_ELEMS and
    PRUNED_MIN_KEYS): both kernels at the searches the main paths run and
    self searches of a uniform cloud at K 1 and 16; whether the rule sends
    each to the faster one."""
    shapes = [(3, 531, 1593, 12), (3, 1593, 4779, 12), (3, 4779, 14336, 12),
              (1, 32768, 531, 14), (1, 32768, 2124, 14), (3, 531, 531, 16),
              (3, 1593, 1593, 16), (3, 4779, 4779, 16), (3, 14336, 14336, 16)]
    shapes += [(1, n, n, k) for n in (1024, 2048, 4779, 9000) for k in (1, 16)]
    table = []
    for B, N, M, K in shapes:
        keys = torch.tensor(rng.rand(B, M, 3).astype(np.float32) * 4 - 2, device=dev)
        same = N == M
        qs = keys if same else torch.tensor(rng.rand(B, N, 3).astype(np.float32) * 4 - 2,
                                            device=dev)
        q, kk, kn, _ = t_knn._prepare(qs, keys, None)
        p_ms = cuda_ms(torch, lambda: t_knn._pruned_cuda(q, kk, kn, K, same), 5)
        b_ms = cuda_ms(torch, lambda: t_knn.knn_rank(q, kk, kn, K), 5)
        rule = t_knn.use_pruned(N, M, K)
        table.append(dict(shape=[B, N, M, K], pruned_ms=p_ms, brute_ms=b_ms,
                          rule='pruned' if rule else 'brute',
                          rule_picks_faster=(p_ms <= b_ms) == rule))
    emit(dict(phase='knn_crossover', pruned_min_elems=t_knn.PRUNED_MIN_ELEMS,
              pruned_min_keys=t_knn.PRUNED_MIN_KEYS,
              rule='pruned iff N * M * K >= PRUNED_MIN_ELEMS and M >= PRUNED_MIN_KEYS',
              rule_picks_faster=sum(r['rule_picks_faster'] for r in table), of=len(table),
              table=table))


def fps_line(torch, t_fps, dev, rng, B, N, n_out):
    """One FPS line: B clouds of N points (the second example with a
    quarter of its points invalid and a random valid start, above 100000
    points duplicates and integer-grid ties), the kernel's picks against
    the plain loop's (exact), its time and time per pick, the entry and
    launch shape the speed rule takes, the bound. :return the {"kernels"}
    row."""
    xyz = rng.rand(B, N, 3).astype(np.float32) * 4 - 2
    valid = np.ones((B, N), bool)
    start = np.zeros(B, np.int64)
    if B > 1:
        valid[1] = rng.rand(N) > 0.25
        start[1] = int(rng.choice(np.flatnonzero(valid[1])))
    if N > 100000:
        xyz[:, N // 2:N // 2 + 1000] = xyz[:, :1000]
        xyz[:, -5000:] = np.round(xyz[:, -5000:])
        start[0] = int(rng.randint(N))
    args = (torch.tensor(xyz, device=dev), n_out, torch.tensor(valid, device=dev),
            torch.tensor(start, device=dev))
    s_k = t_fps._fps_cuda(*args)
    s_p = t_fps.fps_plain(*args)
    torch.cuda.synchronize()
    ok = bool(torch.equal(s_k, s_p))
    ms = cuda_ms(torch, lambda: t_fps._fps_cuda(*args), 3)
    plain_ms = cuda_ms(torch, lambda: t_fps.fps_plain(*args), 1, warmup=0)
    C, T = t_fps.fps_plan(B, N)
    b_ms, b_by = bound(B * (N * 12 + N + n_out * 4), 10.0 * B * N * n_out)
    row = dict(max_abs_err=0.0 if ok else int((s_k != s_p).sum()), ms=ms,
               us_per_pick=ms * 1e3 / max(1, n_out - 1), plain_ms=plain_ms, library_ms=None,
               bound_ms=b_ms, bound_by=b_by, shape=[B, N, n_out],
               entry='fps_cluster' if C > 1 else 'fps', cluster=C, threads=T)
    emit(dict(phase='kernel', name=row['entry'], agree=ok, tolerance='exact (equal indices)',
              **row))
    if not ok:
        raise AssertionError(f'fps disagrees at {(B, N, n_out)}')
    return row


def check_fps_cluster(torch, t_fps, dev, rng, rows):
    """The FPS cluster entry at the n57344 encoder's first level (57344 ->
    19115): a random start, start 0, an invalid-point mask with a random
    valid start, and duplicated points; indices equal to the plain loop's on
    the card in every case."""
    N, n_out = 57344, 19115
    xyz = torch.tensor(rng.rand(1, N, 3).astype(np.float32) * 4.0 - 2.0, device=dev)
    dup = xyz.clone()
    dup[:, N // 2:] = dup[:, :N - N // 2]                       # every point twice.
    ones = torch.ones((1, N), dtype=torch.bool, device=dev)
    mask = torch.tensor(rng.rand(1, N) > 0.25, device=dev)
    starts = torch.tensor([int(rng.randint(N))], device=dev)
    cases = [('random_start', xyz, ones, starts),
             ('start_0', xyz, ones, torch.zeros((1,), dtype=torch.int64, device=dev)),
             ('masked', xyz, mask, torch.tensor([int(torch.nonzero(mask[0])[123])],
                                               device=dev)),
             ('duplicates', dup, ones, starts)]
    eq = {}
    for name, pts, valid, start in cases:
        got = t_fps._fps_cuda(pts, n_out, valid, start)
        want = t_fps.fps_plain(pts, n_out, valid, start)
        torch.cuda.synchronize()
        eq[name] = bool(torch.equal(got, want))
    ok = all(eq.values())
    args = (xyz, n_out, ones, starts)
    ms = cuda_ms(torch, lambda: t_fps._fps_cuda(*args), 5)
    plain_ms = cuda_ms(torch, lambda: t_fps.fps_plain(*args), 1, warmup=0)
    b_ms, b_by = bound(N * 12 + N * 4 + n_out * 4, 10.0 * N * n_out)
    emit(dict(phase='kernel', name='fps_cluster', shape=[N, n_out], agree=ok, exact=eq,
              max_abs_err=0 if ok else -1, tolerance='exact (equal indices)', ms=ms,
              us_per_pick=ms * 1e3 / (n_out - 1), plain_ms=plain_ms, library_ms=None,
              bound_ms=b_ms, bound_by=b_by))
    if not ok:
        raise AssertionError(f'fps_cluster differs from its plain version: {eq}')
    rows['fps_cluster'] = dict(max_abs_err=0.0, ms=ms, us_per_pick=ms * 1e3 / (n_out - 1),
                               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                               library_ms=None, shape=[N, n_out])


def set_fused_attention(encoder, mode):
    """The self-attention path of every PT block of `encoder`."""
    for block in encoder.blocks:
        if hasattr(block, 'layer2'):
            block.layer2.fused = mode


def encoder_on_off_check(torch, tr, batch, dev):
    """The encoder with fused_attention 'on' against 'auto' on the card, on
    the seeded state and batch with the same FPS starts, the loss a fixed
    seeded projection of both outputs. Three gates, each on a tensor's L2
    error over max(1, its 'auto' L2 norm):

    * every PT block alone, on the inputs and the output cotangent the
      'auto' run gave it: its output, d(input) and every weight gradient
      within 1e-4 (the decoder check's gate; only ReLU flips separate the
      two paths);
    * the encoder's two outputs within 1e-5;
    * every encoder gradient within 1e-2: upstream of a DownTransition the
      two paths also differ where the max-pool over 12 neighbours has two
      candidates within rounding of each other, and such a flip sends that
      (point, channel)'s whole gradient to another point. The flips are
      counted (pool_argmax_flips) and reported with the errors."""
    import importlib
    from occlusions4d_torch.ops import _build
    t_knn = importlib.import_module('occlusions4d_torch.ops.knn')
    enc = tr.encoder
    pts = [b for b in enc.blocks if hasattr(b, 'layer2')]
    downs = [b for b in enc.blocks if not hasattr(b, 'layer2')]
    params = list(enc.parameters())
    names = ['pcl_out', 'x_global'] + [n for n, _ in enc.named_parameters()]
    wrng = np.random.RandomState(12)
    w_out = w_glob = None
    res = {}

    def rel_l2(a, b):
        return float((a - b).norm()) / max(1.0, float(b.norm()))

    for mode in ('on', 'auto'):
        set_fused_attention(enc, mode)
        seen = dict(att=[], pool=[])

        def att_hook(m, args, out):
            seen['att'].append((args[0].detach(), args[1].detach(), out))

        def pool_hook(m, args, out):
            with torch.no_grad():
                _, nbr = t_knn.knn(out[1], args[1], m.knn_k)
                z = t_knn.gather_neighbors(m.mlp(args[0]), nbr)
                seen['pool'].append(z.argmax(dim=-2))
        hooks = ([b.layer2.register_forward_hook(att_hook) for b in pts]
                 + [d.register_forward_hook(pool_hook) for d in downs])
        _build.reset_launch_counts()
        try:
            out, glob = enc(batch['pcl_input'],
                            generator=torch.Generator(dev).manual_seed(13))
        finally:
            for h in hooks:
                h.remove()
        if w_out is None:
            w_out = torch.tensor(wrng.randn(*out.shape).astype(np.float32), device=dev)
            w_glob = torch.tensor(wrng.randn(*glob.shape).astype(np.float32), device=dev)
        loss = (out * w_out).sum() + (glob * w_glob).sum()
        grads = torch.autograd.grad(loss, params + [o for _, _, o in seen['att']])
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        res[mode] = dict(
            tensors=[out.detach(), glob.detach()] + [g.detach() for g in grads[:len(params)]],
            blocks=[(x, p, g) for (x, p, _), g in zip(seen['att'], grads[len(params):])],
            pool=seen['pool'], launches={k: counts[k] for k in ('sattn', 'sattn_bwd',
                                                                'gather', 'scatter')})

    # Every PT block alone on the 'auto' run's inputs and output cotangent.
    block_err = []
    for i, (b, (x, p, g_up)) in enumerate(zip(pts, res['auto']['blocks'])):
        att = b.layer2
        got = {}
        for mode in ('on', 'auto'):
            att.fused = mode
            xx = x.clone().requires_grad_(True)
            y = att(xx, p)
            got[mode] = [y.detach()] + list(torch.autograd.grad(
                y, [xx] + list(att.parameters()), g_up))
        block_err.append(max(rel_l2(a, c) for a, c in zip(got['on'], got['auto'])))
    set_fused_attention(enc, tr.fused_attention)

    per = [dict(name=n, rel_l2=rel_l2(a, b),
                max_scaled=float((a - b).abs().max()) / max(1.0, float(b.abs().max())))
           for n, a, b in zip(names, res['on']['tensors'], res['auto']['tensors'])]
    worst = max(per[2:], key=lambda x: x['rel_l2'])
    flips = [int((a != b).sum()) for a, b in zip(res['on']['pool'], res['auto']['pool'])]
    check = dict(tensors=len(per), output_rel_l2=max(x['rel_l2'] for x in per[:2]),
                 grad_max_rel_l2=worst['rel_l2'], worst_grad=worst,
                 grad_max_scaled_err=max(x['max_scaled'] for x in per[2:]),
                 block_max_rel_l2=block_err, pool_argmax_flips=flips,
                 pool_outputs=[int(a.numel()) for a in res['auto']['pool']],
                 tolerance=('L2 error over max(1, L2 norm): each PT block alone 1e-4, '
                            'encoder outputs 1e-5, encoder gradients 1e-2'),
                 launches_on=res['on']['launches'], launches_auto=res['auto']['launches'])
    check['ok'] = (max(block_err) <= 1e-4 and check['output_rel_l2'] <= 1e-5
                   and worst['rel_l2'] <= 1e-2
                   and res['on']['launches'] == dict(sattn=4, sattn_bwd=4, gather=4,
                                                     scatter=4)
                   and res['auto']['launches'] == dict(sattn=0, sattn_bwd=0, gather=0,
                                                       scatter=0))
    return check


def run_train_phase(torch, tr, batch, n_steps):
    """1 warm-up + n_steps timed Trainer steps (launch counters zeroed just
    before the timed steps, read just after), then one phase-split step:
    (steps, counts, largest parameter change, peak GiB, split, warm-up ms)."""
    from occlusions4d_torch.ops import _build
    before = [p.detach().clone() for p in tr.optimizer.params]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    tr.step(batch)                              # warm-up step, not counted.
    torch.cuda.synchronize()
    warm_ms = (time.time() - t0) * 1e3
    _build.reset_launch_counts()
    steps = []
    for _ in range(n_steps):
        t0 = time.time()
        m = tr.step(batch)
        torch.cuda.synchronize()
        steps.append(dict(ms=(time.time() - t0) * 1e3,
                          **{k: (v.tolist() if v.dim() else v.item()) for k, v in m.items()}))
    counts = _build.launch_counts()
    changed = max(max_err(p, q) for p, q in zip(tr.optimizer.params, before))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    return steps, counts, changed, peak_gb, split_step(torch, tr, batch), warm_ms


def train_fused_phase(torch, dev, smi, path_counts, name, cfg_kw, expect, seed):
    """A train step with fused_attention='on' (Trainer on 'greater', seeded
    numpy weights, a bench.py-shaped batch): for train_sattn first the
    encoder 'on' vs 'auto' check; then 1 warm-up + 2 timed steps with the
    launches per step checked against `expect`, finite losses, gradients
    and parameters, changed parameters, one phase-split step."""
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.train import Trainer
    cfg = TrainConfig(**cfg_kw)
    tr = Trainer(cfg, 'greater', 'cuda', fused_attention='on')
    wrng = np.random.RandomState(seed)
    tr.init_state(params=dict(encoder=random_jax_params(tr.encoder, wrng),
                              decoder=random_jax_params(tr.decoder, wrng)),
                  seed=0, steps_per_epoch=100)
    batch = train_batch(torch, cfg, dev, seed=seed + 1)
    check = encoder_on_off_check(torch, tr, batch, dev) if name == 'train_sattn' else None
    n_steps = 2
    steps, counts, changed, peak_gb, split, warm_ms = run_train_phase(torch, tr, batch,
                                                                      n_steps)
    path_counts[name] = counts
    per_step = {k: counts.get(k, 0) / n_steps for k in expect}
    counts_ok = per_step == {k: float(v) for k, v in expect.items()}
    finite = all(np.isfinite(st['total_loss']) and st['grads_finite'] and st['params_finite']
                 and st['sample_ok'] for st in steps)
    ok = counts_ok and finite and changed > 0.0 and (check is None or check['ok'])
    emit(dict(phase=name, model='gv1', n_points=cfg.n_points, batch_size=cfg.batch_size,
              frames=cfg.past_frames, fused_attention='on', warmup_ms=warm_ms,
              step_ms=[st['ms'] for st in steps],
              mean_step_ms=float(np.mean([st['ms'] for st in steps])), steps=steps,
              launches=counts, launches_per_step=per_step, expected_per_step=expect,
              params_changed_max_abs=changed, split_ms=split, peak_mem_gib=peak_gb,
              encoder_on_vs_auto=check, ok=bool(ok), gpu=smi))
    if not ok:
        raise AssertionError(f'{name} failed: launches {per_step} (expected {expect}), '
                             f'finite {finite}, changed {changed}, on vs auto {check}')


def train_batch(torch, cfg, dev, seed=1, data_kind='greater'):
    """A seeded synthetic batch shaped as bench.py:57-82 builds it (GREATER
    or CARLA layout, target budget 2 x n_points), on the card."""
    rng = np.random.RandomState(seed)
    B, N, T = cfg.batch_size, cfg.n_points, cfg.past_frames + cfg.future_frames
    M, half = 2 * N, cfg.cr_cube_bounds
    E = 9 if data_kind == 'greater' else 11
    tgt = np.zeros((B, T, M, E), np.float32)
    tgt[..., :3] = rng.rand(B, T, M, 3) * 2.0 * half - half
    tgt[..., 2] = np.abs(tgt[..., 2])
    if data_kind == 'greater':
        tgt[..., 5:8] = rng.rand(B, T, M, 3)
    else:  # CARLA layout: inst 4, segm 5, view 6, rgb 7:10.
        tgt[..., 4] = rng.randint(0, 50, (B, T, M))
        tgt[..., 5] = rng.randint(0, 23, (B, T, M))
        tgt[..., 6] = rng.randint(0, 4, (B, T, M))
        tgt[..., 7:10] = rng.rand(B, T, M, 3)
    R = 32 if data_kind == 'greater' else 256   # valo capacity per dataset.
    batch = dict(pcl_input=(rng.rand(B, N, 8) * 2 - 1).astype(np.float32),
                 pcl_target=tgt, pcl_target_valid=np.ones((B, T, M), bool),
                 valo_ids=np.tile(np.arange(R, dtype=np.int32), (B, 1)),
                 num_valo_ids=np.full((B,), 8, np.int32))
    return {k: torch.tensor(v, device=dev) for k, v in batch.items()}


def split_step(torch, tr, batch):
    """One more Trainer.step, with a synchronize at each phase mark of the
    step: ms of each phase (make_train_step's names), in order."""
    torch.cuda.synchronize()
    marks = [('start', time.time())]

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.time()))
    tr.step(batch, mark=mark)
    return {n: (t - marks[i][1]) * 1e3 for i, (n, t) in enumerate(marks[1:])}


_SHARED_ROUTE = dict(gather=1, interp_g=1, attn_g=2, scatter=1, interp_bwd=1, attn_g_bwd=2,
                     interp_g_bwd=0)
_INDEX_ROUTE = dict(interp=1, attn=2, interp_bwd=1, attn_bwd=2, gather=0, attn_g=0,
                    attn_g_bwd=0)


def decoder_grad_check(torch, tr, abstract, fg, frame, dev, expect=_SHARED_ROUTE):
    """One decoder forward + backward of a sampled frame's first 1024
    queries on the card and on the CPU (plain versions, the same route):
    loss, d(abstract) and every decoder parameter gradient compared; the
    card's launches must be `expect` (the route's kernels).

    Each gradient passes on its L2 error over max(1, its CPU L2 norm) <=
    1e-4. Its largest single-element error is reported and not gated: an
    f32 pre-activation within rounding of zero can take the other side of
    a ReLU on the card than on the CPU, which moves that row's share of a
    gradient: single elements read 4.2e-5 to 3.7e-4 of the tensor's largest
    entry over three runs on the H100."""
    import copy
    from occlusions4d_torch.losses import total_loss
    from occlusions4d_torch.ops import _build
    from occlusions4d_torch.pipeline import TrainPipeline
    from occlusions4d_torch.sampler import SamplerConfig
    sub = dict(frame, points_query=frame['points_query'][:, :_GRAD_CHECK_Q],
               implicit_target=frame['implicit_target'][:, :_GRAD_CHECK_Q])
    cpu_pipe = TrainPipeline(None, copy.deepcopy(tr.decoder).cpu(),
                             SamplerConfig(**tr.sampler_args), tr.pipeline_cfg)
    names = ['abstract'] + [n for n, _ in tr.decoder.named_parameters()]
    res, launched = {}, None
    for name, pipe, d in (('cuda', tr.pipeline, dev), ('cpu', cpu_pipe, torch.device('cpu'))):
        fr = {k: v.to(d) for k, v in sub.items()}
        a = abstract.detach().to(d).requires_grad_(True)
        _build.reset_launch_counts()
        t0 = time.time()
        losses, _ = pipe.decode_frames([fr], a, fg.to(d))
        loss = total_loss(losses, pipe.cfg.loss_config)
        grads = torch.autograd.grad(loss, [a] + list(pipe.decoder.parameters()))
        if d.type == 'cuda':
            torch.cuda.synchronize()
            launched = {k: _build.launch_counts()[k] for k in expect}
        res[name] = (float(loss.detach()), [x.cpu() for x in grads], time.time() - t0)
    per = []
    for n, a, b in zip(names, res['cuda'][1], res['cpu'][1]):
        diff, scale = (a - b).abs(), max(1.0, float(b.abs().max()))
        per.append(dict(name=n, rel_l2=float(diff.norm()) / max(1.0, float(b.norm())),
                        max_scaled=float(diff.max()) / scale,
                        over_1e4=int((diff > 1e-4 * scale).sum()), size=b.numel()))
    worst = max(per, key=lambda x: x['max_scaled'])
    out = dict(queries=_GRAD_CHECK_Q, loss=[res['cuda'][0], res['cpu'][0]],
               loss_rel_err=abs(res['cuda'][0] - res['cpu'][0]) / max(1.0, abs(res['cpu'][0])),
               max_rel_l2=max(x['rel_l2'] for x in per),
               max_scaled_err=worst['max_scaled'], worst=worst,
               elements_over_1e4=sum(x['over_1e4'] for x in per),
               elements=sum(x['size'] for x in per),
               tolerance='loss 1e-5; each gradient L2 error <= 1e-4 x max(1, its L2 norm)',
               launches=launched, cpu_s=res['cpu'][2])
    out['ok'] = (out['loss_rel_err'] <= 1e-5 and out['max_rel_l2'] <= 1e-4
                 and launched == expect)
    return out


def train_cv1(torch, dev, smi, path_counts):
    """Phase 8, from seeded weights: one sampled frame (its scatter segments
    and the scatter's time on them, and decoder_grad_check), then 1 warm-up
    + 2 timed cv1 train steps (launch counts per step, finite and changed
    state) and one phase-split step."""
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.train import Trainer
    import importlib
    t_attn = importlib.import_module('occlusions4d_torch.ops.attention')
    cfg = TrainConfig(**_CV1_TRAIN)
    tr = Trainer(cfg, 'carla', 'cuda')
    wrng = np.random.RandomState(6)
    tr.init_state(params=dict(encoder=random_jax_params(tr.encoder, wrng),
                              decoder=random_jax_params(tr.decoder, wrng)),
                  seed=0, steps_per_epoch=100)
    batch = train_batch(torch, cfg, dev, seed=7, data_kind='carla')

    # One sampled frame of the seeded state (the same inputs in every run).
    with torch.no_grad():
        abstract, fg = tr.encoder(batch['pcl_input'], generator=tr.generator)
        frame = tr.pipeline.sample_frames(batch, tr.generator)[0]
        ki, _ = t_attn.knn_extract(frame['points_query'][..., :3], abstract[..., :3],
                                   cfg.cross_attn_neighbors)
        M, K = abstract.shape[1], ki.shape[-1]
        offsets = t_attn.scatter_index(ki, M, K, K)[1]
        seg = torch.diff(offsets)
        longest, chunks = segments(torch, offsets)
        # The scatter on this skewed frame, against uniform clouds' (kernel
        # line), beside scatter_add_ on the same rows.
        dg = torch.randn((ki.shape[0], K, ki.shape[1], abstract.shape[2]), device=dev)
        frame_scatter_ms = cuda_ms(torch, lambda: t_attn.gather_bwd(ki, dg, M, K), 10)
        frame_lib_ms = scatter_add_ms(torch, ki, dg, M, K, dev)[0]
        del dg
    check = decoder_grad_check(torch, tr, abstract, fg, frame, dev)

    n_steps = 2
    steps, counts, changed, peak_gb, split, warm_ms = run_train_phase(torch, tr, batch,
                                                                      n_steps)
    path_counts['train_cv1'] = counts
    per_step = {k: counts.get(k, 0) / n_steps for k in _CV1_STEP}
    counts_ok = per_step == {k: float(v) for k, v in _CV1_STEP.items()} \
        and counts.get('nn1_bidir', 0) > 0
    finite = all(np.isfinite(st['total_loss']) and np.isfinite(st['loss_segm'])
                 and st['loss_segm'] > 0 and st['grads_finite'] and st['params_finite']
                 and st['sample_ok'] for st in steps)
    ok = counts_ok and finite and changed > 0.0 and check['ok']
    emit(dict(phase='train_cv1', model='cv1', batch_size=cfg.batch_size,
              frames=cfg.past_frames, queries_per_frame=_CV1_N,
              abstract_points=int(abstract.shape[1]), warmup_ms=warm_ms,
              step_ms=[st['ms'] for st in steps],
              mean_step_ms=float(np.mean([st['ms'] for st in steps])), steps=steps,
              launches=counts, launches_per_step=per_step, expected_per_step=_CV1_STEP,
              params_changed_max_abs=changed, split_ms=split, peak_mem_gib=peak_gb,
              scatter_longest_segment=int(seg.max()),
              scatter_mean_segment=float(seg.float().mean()),
              scatter_longest_segment_chunks=chunks, scatter_ms_on_frame=frame_scatter_ms,
              scatter_add_ms_on_frame=frame_lib_ms, grad_check=check, ok=bool(ok), gpu=smi))
    if not ok:
        raise AssertionError(f'train_cv1 failed: launches {per_step} (expected '
                             f'{_CV1_STEP}, nn1_bidir {counts.get("nn1_bidir")}), finite '
                             f'{finite}, changed {changed}, card vs CPU {check}')
    return dict(ms=frame_scatter_ms, library_ms=frame_lib_ms, longest_segment=longest,
                longest_segment_chunks=chunks)


def train_bf16(torch, dev, smi, path_counts):
    """Phase 8b: the gv1 and cv1 train steps with fused_decoder_dtype='bf16'
    beside f32 steps from the same seeded weights, batch and generator seed:
    _BF16_TRAIN_STEPS steps each, the launch counters zeroed after the first
    and read after the last (per step: _BF16_STEP, and the f32 run none of
    the bf16 kernels), finite state, every step's loss within
    _BF16_LOSS_RTOL of the f32 run's, the step times side by side."""
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.ops import _build
    from occlusions4d_torch.train import Trainer
    path_counts['train_bf16'] = {}
    n = _BF16_TRAIN_STEPS - 1
    bf16_names = sorted({k for e in _BF16_STEP.values() for k in e} - set(_F32_DECODER))
    for model, kw, kind, wseed, bseed in (('gv1', _GV1_TRAIN, 'greater', 2, 1),
                                          ('cv1', _CV1_TRAIN, 'carla', 6, 7)):
        res = {}
        for dtype in ('f32', 'bf16'):
            cfg = TrainConfig(**dict(kw, fused_decoder_dtype=dtype))
            tr = Trainer(cfg, kind, 'cuda')
            wrng = np.random.RandomState(wseed)
            tr.init_state(params=dict(encoder=random_jax_params(tr.encoder, wrng),
                                      decoder=random_jax_params(tr.decoder, wrng)),
                          seed=0, steps_per_epoch=100)
            batch = train_batch(torch, cfg, dev, seed=bseed, data_kind=kind)
            torch.cuda.reset_peak_memory_stats()
            steps = []
            for i in range(_BF16_TRAIN_STEPS):
                torch.cuda.synchronize()
                if i == 1:
                    _build.reset_launch_counts()
                t0 = time.time()
                m = tr.step(batch)
                torch.cuda.synchronize()
                steps.append(dict(ms=(time.time() - t0) * 1e3,
                                  total_loss=float(m['total_loss']),
                                  finite=bool(m['grads_finite']) and bool(m['params_finite'])
                                  and bool(np.isfinite(float(m['total_loss'])))))
            res[dtype] = dict(steps=steps, counts=_build.launch_counts(),
                              peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                              mean_step_ms=float(np.mean([st['ms'] for st in steps[1:]])))
            del tr, batch
            torch.cuda.empty_cache()
        expect = _BF16_STEP[model]
        per_step = {k: res['bf16']['counts'].get(k, 0) / n for k in expect}
        counts_ok = per_step == {k: float(v) for k, v in expect.items()} and all(
            res['f32']['counts'].get(k, 0) == 0 for k in bf16_names)
        loss_rel = [abs(b['total_loss'] - f['total_loss']) / abs(f['total_loss'])
                    for b, f in zip(res['bf16']['steps'], res['f32']['steps'])]
        finite = all(st['finite'] for r in res.values() for st in r['steps'])
        ok = counts_ok and finite and max(loss_rel) <= _BF16_LOSS_RTOL
        for k, v in res['bf16']['counts'].items():
            path_counts['train_bf16'][k] = path_counts['train_bf16'].get(k, 0) + v
        emit(dict(phase='train_bf16', model=model, steps=_BF16_TRAIN_STEPS,
                  timed_steps=n, bf16_step_ms=[st['ms'] for st in res['bf16']['steps']],
                  f32_step_ms=[st['ms'] for st in res['f32']['steps']],
                  bf16_mean_step_ms=res['bf16']['mean_step_ms'],
                  f32_mean_step_ms=res['f32']['mean_step_ms'],
                  speedup=res['f32']['mean_step_ms'] / res['bf16']['mean_step_ms'],
                  bf16_loss=[st['total_loss'] for st in res['bf16']['steps']],
                  f32_loss=[st['total_loss'] for st in res['f32']['steps']],
                  loss_rel_diff=loss_rel, loss_rtol=_BF16_LOSS_RTOL,
                  launches_per_step=per_step, expected_per_step=expect,
                  bf16_launches=res['bf16']['counts'],
                  bf16_peak_mem_gib=res['bf16']['peak_mem_gib'],
                  f32_peak_mem_gib=res['f32']['peak_mem_gib'], finite=finite, ok=bool(ok),
                  gpu=smi))
        if not ok:
            raise AssertionError(f'train_bf16 ({model}) failed: launches {per_step} '
                                 f'(expected {expect}), finite {finite}, loss vs f32 '
                                 f'{loss_rel}')


def train_mixed(torch, dev, smi, path_counts):
    """Phase 10b: the gv1 train step with mixed_precision=True (bf16
    networks over f32 parameters, AdamW eps 1e-4) with fused_attention
    'auto' and 'on' and fused_decoder_dtype 'f32' and 'bf16', and the
    n57344 step with 'on', each beside the f32 run of the same options
    (mixed_precision=False: f32 networks, eps 1e-8) from the same seeded
    weights, batch and generator seed, _MIXED_TRAIN_STEPS steps each, then
    one phase-split step each: mean step ms, split_ms and peak memory side
    by side. The launch counters are zeroed before each mixed step after the
    first and read after it (per step _MIXED_STEP / _MIXED_57K_STEP; the f32
    run launches no bf16 self-attention kernel). The loss gate compares each
    mixed step's loss with the f32 networks' loss from the same state: the
    f32 run's modules loaded with the mixed run's parameters and the same
    generator state, forward only, before the step; each within
    _BF16_LOSS_RTOL. The two runs' own trajectories part from the second
    step on (AdamW's eps 1e-4 against 1e-8 damps every update whose moments
    are near 1e-4, as the clipped gradients' entries are), so they are
    printed, not gated. Every state finite."""
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.ops import _build
    from occlusions4d_torch.train import Trainer
    path_counts['train_mixed'] = {}
    n = _MIXED_TRAIN_STEPS - 1
    arms = [('gv1', _GV1_TRAIN, fused, ddt, _MIXED_STEP[fused])
            for fused in ('auto', 'on') for ddt in ('f32', 'bf16')]
    arms.append(('n57344', _N57, 'on', 'auto', _MIXED_57K_STEP))

    def trainer(kw, fused, ddt, mixed):
        cfg = TrainConfig(**dict(kw, fused_decoder_dtype=ddt, mixed_precision=mixed))
        tr = Trainer(cfg, 'greater', 'cuda', fused_attention=fused)
        wrng = np.random.RandomState(2)
        tr.init_state(params=dict(encoder=random_jax_params(tr.encoder, wrng),
                                  decoder=random_jax_params(tr.decoder, wrng)),
                      seed=0, steps_per_epoch=100)
        return tr, train_batch(torch, cfg, dev, seed=1)

    def f32_loss_at(tr32, tr, batch):
        """The f32 networks' loss at tr's parameters and generator state."""
        tr32.encoder.load_state_dict(tr.encoder.state_dict())
        tr32.decoder.load_state_dict(tr.decoder.state_dict())
        gen = torch.Generator(dev)
        gen.set_state(tr.generator.get_state())
        with torch.no_grad():
            return float(tr32.pipeline.loss(batch, gen)[0])

    for model, kw, fused, ddt, expect in arms:
        res = {}
        tr32, batch = trainer(kw, fused, ddt, False)
        tr, _ = trainer(kw, fused, ddt, True)
        for name, t in (('f32', tr32), ('mixed', tr)):
            torch.cuda.reset_peak_memory_stats()
            steps, counts = [], {}
            for i in range(_MIXED_TRAIN_STEPS):
                same = f32_loss_at(tr32, t, batch) if name == 'mixed' else None
                torch.cuda.synchronize()
                _build.reset_launch_counts()
                t0 = time.time()
                m = t.step(batch)
                torch.cuda.synchronize()
                if i >= 1:
                    for k, v in _build.launch_counts().items():
                        counts[k] = counts.get(k, 0) + v
                steps.append(dict(ms=(time.time() - t0) * 1e3,
                                  total_loss=float(m['total_loss']), f32_same_state=same,
                                  finite=bool(m['grads_finite']) and bool(m['params_finite'])
                                  and bool(np.isfinite(float(m['total_loss'])))))
            res[name] = dict(steps=steps, counts=counts,
                             peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                             split_ms=split_step(torch, t, batch), eps=t.optimizer.eps,
                             mean_step_ms=float(np.mean([st['ms'] for st in steps[1:]])))
        del tr, tr32, batch
        torch.cuda.empty_cache()
        mp, f32 = res['mixed'], res['f32']
        per_step = {k: mp['counts'].get(k, 0) / n for k in expect}
        counts_ok = per_step == {k: float(v) for k, v in expect.items()} and all(
            f32['counts'].get(k, 0) == 0 for k in ('sattn_bf16', 'sattn_bwd_bf16'))
        loss_rel = [abs(st['total_loss'] - st['f32_same_state']) / abs(st['f32_same_state'])
                    for st in mp['steps']]
        traj_rel = [abs(b['total_loss'] - f['total_loss']) / abs(f['total_loss'])
                    for b, f in zip(mp['steps'], f32['steps'])]
        finite = all(st['finite'] for r in res.values() for st in r['steps'])
        ok = (counts_ok and finite and max(loss_rel) <= _BF16_LOSS_RTOL
              and mp['eps'] == 1e-4 and f32['eps'] == 1e-8)
        for k, v in mp['counts'].items():
            path_counts['train_mixed'][k] = path_counts['train_mixed'].get(k, 0) + v
        emit(dict(phase='train_mixed', model=model, fused_attention=fused,
                  fused_decoder_dtype=ddt, steps=_MIXED_TRAIN_STEPS, timed_steps=n,
                  mixed_step_ms=[st['ms'] for st in mp['steps']],
                  f32_step_ms=[st['ms'] for st in f32['steps']],
                  mixed_mean_step_ms=mp['mean_step_ms'], f32_mean_step_ms=f32['mean_step_ms'],
                  speedup=f32['mean_step_ms'] / mp['mean_step_ms'],
                  mixed_split_ms=mp['split_ms'], f32_split_ms=f32['split_ms'],
                  mixed_loss=[st['total_loss'] for st in mp['steps']],
                  f32_loss_same_state=[st['f32_same_state'] for st in mp['steps']],
                  loss_rel_diff_same_state=loss_rel, loss_rtol=_BF16_LOSS_RTOL,
                  f32_run_loss=[st['total_loss'] for st in f32['steps']],
                  trajectory_rel_diff=traj_rel,
                  launches_per_step=per_step, expected_per_step=expect,
                  mixed_launches=mp['counts'], mixed_peak_mem_gib=mp['peak_mem_gib'],
                  f32_peak_mem_gib=f32['peak_mem_gib'], adamw_eps=[mp['eps'], f32['eps']],
                  finite=finite, ok=bool(ok), gpu=smi))
        if not ok:
            raise AssertionError(f'train_mixed ({model}, {fused}, {ddt}) failed: launches '
                                 f'{per_step} (expected {expect}), finite {finite}, loss vs '
                                 f'f32 from the same state {loss_rel}, eps {mp["eps"]} / '
                                 f'{f32["eps"]}')


def attn_g_grads_f64(torch, t_attn, q_pos, q_proj, g, params, k, go):
    """d(q_proj) and the weight gradients of the gathered attention in
    float64 (autograd through attn_g_plain on float64 inputs and weights):
    the reference of attn_g_bwd_chunk_line."""
    leaves = {nl: params[nl[0]][nl[1]].detach().double().requires_grad_(True)
              for nl in t_attn._grad_names(False)}
    qp = q_proj.detach().double().requires_grad_(True)
    with torch.enable_grad():
        out = t_attn.attn_g_plain(q_pos.double(), qp, g.double(),
                                  t_attn._params(leaves, leaves.values()), k)
        grads = torch.autograd.grad(out, [qp] + list(leaves.values()), go.double())
    return grads[0], dict(zip(leaves, grads[1:]))


def attn_g_bwd_chunk_line(torch, t_attn, name, qxyz, q_proj, g, params, K, go, shape):
    """attn_g_bwd on one decode chunk's rows, the kernel and its plain f32
    version each against float64. Gate, on every leaf (d(q_proj) and each
    weight gradient), in units of max(1, max|plain|): the kernel's error
    against float64 at most twice the plain version's, or 1e-6 where that
    is smaller. (On the chunk both f32 versions lie about 7e-3 from float64,
    far above the 5e-6 by which the cv1 frames hold the kernel to its plain
    version.) :return the line's row."""
    with torch.no_grad():
        a = t_attn.attn_g_bwd(qxyz, q_proj, g, params, K, go)
    b = t_attn.attn_g_bwd_plain(qxyz, q_proj, g, params, K, go)
    c = attn_g_grads_f64(torch, t_attn, qxyz, q_proj, g, params, K, go)
    torch.cuda.synchronize()
    leaves = {'q_proj': (a[0], b[0], c[0])}
    leaves.update({'/'.join(n): (a[2][n], b[2][n], c[1][n]) for n in sorted(b[2])})
    per_leaf = {}
    for leaf, (u, v, w) in leaves.items():
        sc = max(1.0, float(v.abs().max()))
        kf, pf = (float((u.double() - w).abs().max()) / sc,
                  float((v.double() - w).abs().max()) / sc)
        per_leaf[leaf] = dict(kernel_vs_plain=float((u - v).abs().max()) / sc,
                              kernel_vs_f64=kf, plain_vs_f64=pf,
                              ok=kf <= 2.0 * max(pf, 1e-6))
    ok = all(r['ok'] for r in per_leaf.values())
    row = dict(agree=ok, kernel_vs_plain=max(r['kernel_vs_plain'] for r in per_leaf.values()),
               kernel_vs_f64=max(r['kernel_vs_f64'] for r in per_leaf.values()),
               plain_vs_f64=max(r['plain_vs_f64'] for r in per_leaf.values()),
               worst_ratio=max(r['kernel_vs_f64'] / max(r['plain_vs_f64'], 1e-6)
                               for r in per_leaf.values()),
               tolerance='per leaf: kernel vs float64 <= 2 x max(plain vs float64, 1e-6), '
                         'of max(1, max|plain|)',
               shape=shape, per_leaf=per_leaf)
    emit(dict(phase='kernel', name=f'{name}_attn_g_bwd_chunk', **row))
    if not ok:
        raise AssertionError(f'{name} attn_g_bwd on the decode chunk: farther from float64 '
                             f'than twice its plain version: {per_leaf}')
    return row


def wide_attention_lines(torch, t_attn, dev, rng, name, params, qxyz, abstract):
    """The decoder's first attention layer at a width above one 416-column
    block. Forward, on one decode chunk's rows: attn (premul and per-row)
    and attn_g against their plain versions (atol 1e-4, rtol 1e-3, twice for
    the same bits, attn_g and the per-row route bit-equal). Backward, on the
    recipes their gates were set on: attn_bwd (premul) at the train step's
    frame (3 x 17920 queries, 531 keys; 1e-4 of scale, rtol 1e-3, as
    check_backward_kernels) and attn_g_bwd at one cv1 train frame (3 x 17203
    queries, 2124 keys; 5e-6 of scale, as check_shared_gather_backward_kernels),
    each twice for the same bits. Also attn_g_bwd on the decode chunk
    against float64 (attn_g_bwd_chunk_line).
    :return {line name: row}."""
    D = params['attn_mlp_0']['kernel'].shape[0]
    H, P = params['attn_mlp_0']['kernel'].shape[1], params['pos_mlp_0']['kernel'].shape[1]
    pos2, feats2 = abstract[..., :3].contiguous(), abstract[..., 3:].contiguous()
    N, M, E, K = qxyz.shape[1], pos2.shape[1], feats2.shape[-1], 14

    def rand(*shape, scale=None):
        a = rng.rand(*shape) * scale - scale / 2 if scale else rng.randn(*shape)
        return torch.tensor(a.astype(np.float32), device=dev)

    knn = t_attn.knn_extract(qxyz, pos2, K)
    q_proj = rand(1, N, D)
    out = {}
    with torch.no_grad():
        g = t_attn.knn_gather_rows(pos2, feats2, knn, K)
        kvp = torch.cat([feats2 @ params['to_k']['kernel'],
                         feats2 @ params['to_v']['kernel']], -1).contiguous()
    o_route = {}
    for mode, kv in (('premul', kvp), ('per_row', feats2)):
        args = (qxyz, q_proj, knn[0], pos2, kv, params, K, mode == 'premul')
        macs, nbytes = attn_fwd_work(N * K, N, M, 3 + kv.shape[-1], D, E, H, P,
                                     mode == 'per_row')
        out[f'attn_{mode}'], o_route[mode] = attn_fwd_line(
            torch, f'{name}_attn_{mode}', lambda: t_attn._attn_cuda(*args),
            lambda: t_attn.attn_plain(*args), macs, nbytes + N * K * 4, [N, M, K, D, E])
    macs, nbytes = attn_fwd_work(N * K, N, M, 3 + E, D, E, H, P, True)
    out['attn_g'], o_g = attn_fwd_line(
        torch, f'{name}_attn_g', lambda: t_attn._attn_g_cuda(qxyz, q_proj, g, params, K),
        lambda: t_attn.attn_g_plain(qxyz, q_proj, g, params, K), macs, nbytes,
        [N, M, K, D, E])
    out['attn_g']['routes_bit_equal'] = bool(torch.equal(o_g, o_route['per_row']))
    if not out['attn_g']['routes_bit_equal']:
        raise AssertionError(f'{name}: attn_g and the per-row index route differ')
    del o_g, o_route

    out['attn_g_bwd_chunk'] = attn_g_bwd_chunk_line(torch, t_attn, name, qxyz, q_proj, g,
                                                    params, K, rand(1, N, D), [N, M, K, D, E])
    del g

    for bname, (B, NB, MB), gate in (('attn_bwd', (3, 17920, 531), 1e-4),
                                     ('attn_g_bwd', (3, _CV1_N, _CV1_M), 5e-6)):
        bpos, bfeats = rand(B, MB, 3, scale=10.0), rand(B, MB, E)
        bq, bqp, bgo = rand(B, NB, 3, scale=10.0), rand(B, NB, D), rand(B, NB, D)
        bknn = t_attn.knn_extract(bq, bpos, K)
        with torch.no_grad():
            if bname == 'attn_bwd':
                bkv = torch.cat([bfeats @ params['to_k']['kernel'],
                                 bfeats @ params['to_v']['kernel']], -1).contiguous()
                args = (bq, bqp, bknn[0], bpos, bkv, params, K, True, bgo)
                call, plain_fn = (lambda: t_attn.attn_bwd(*args)), t_attn.attn_bwd_plain
            else:
                bg = t_attn.knn_gather_rows(bpos, bfeats, bknn, K)
                args = (bq, bqp, bg, params, K, bgo)
                call, plain_fn = (lambda: t_attn.attn_g_bwd(*args)), t_attn.attn_g_bwd_plain
            x, x2 = call(), call()
        y = plain_per_example(torch, plain_fn, args)
        torch.cuda.synchronize()
        pairs = [(x[0], y[0]), (x[1], y[1])] + [(x[2][n], y[2][n]) for n in sorted(y[2])]
        scaled = max(max_err(u, v) / max(1.0, float(v.abs().max())) for u, v in pairs)
        ok = (scaled <= gate if bname == 'attn_g_bwd' else
              all(bool(torch.allclose(u, v, atol=1e-4 * max(1.0, float(v.abs().max())),
                                      rtol=1e-3)) for u, v in pairs))
        repro = max([max_err(x[0], x2[0]), max_err(x[1], x2[1])]
                    + [max_err(x[2][n], x2[2][n]) for n in x[2]])
        with torch.no_grad():
            ms = cuda_ms(torch, call, 2)
        plain_ms = cuda_ms(torch, lambda: plain_per_example(torch, plain_fn, args), 1)
        row = dict(max_scaled_err=scaled, tolerance=(
            f'atol {gate} x max(1, max|plain|)' + ('' if bname == 'attn_g_bwd' else ', rtol 1e-3')),
            repeat_max_abs_diff=repro, ms=ms, plain_ms=plain_ms, shape=[B, NB, MB, K, D, E])
        emit(dict(phase='kernel', name=f'{name}_{bname}', agree=ok, **row))
        if not ok or repro != 0.0:
            raise AssertionError(f'{name} {bname} disagrees ({scaled}) or is not '
                                 f'reproducible ({repro})')
        out[bname] = row
        del x, x2, y, args
        torch.cuda.empty_cache()
    return out


class plain_kernels:
    """Inside, the decoder's forward kernels (f32 and bf16) are swapped for
    their plain versions, on the card: the plain decode a kernel decode is
    held against, with everything else (the backbone in TF32 included) the
    same."""
    _NAMES = ('_gather_cuda', '_interp_cuda', '_interp_g_cuda', '_attn_cuda', '_attn_g_cuda')

    def __init__(self, torch, t_attn):
        self.t, self.saved = t_attn, {}

        def cd(bf16):
            return torch.bfloat16 if bf16 else torch.float32
        self.plain = dict(
            _gather_cuda=lambda fv, ki, k, bf16=False: t_attn.gather_rows_plain(
                fv, ki, k, cd(bf16)),
            _interp_cuda=lambda ki, kd, feats, k, eps, bf16=False: t_attn.interp_plain(
                ki, kd, feats, k, eps, cd(bf16)),
            _interp_g_cuda=lambda kd, g, k, eps, bf16=False: t_attn.interp_g_plain(
                kd, g, k, eps, cd(bf16)),
            _attn_cuda=lambda q_pos, q_proj, ki, pos2, kv, params, k, premul, bf16=False:
                t_attn.attn_plain(q_pos, q_proj, ki, pos2, kv, params, k, premul, cd(bf16)),
            _attn_g_cuda=lambda q_pos, q_proj, g, params, k, bf16=False: t_attn.attn_g_plain(
                q_pos, q_proj, g, params, k, cd(bf16)))

    def __enter__(self):
        for n in self._NAMES:
            self.saved[n] = getattr(self.t, n)
            setattr(self.t, n, self.plain[n])

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.t, n, f)


def fast_chunk_check(torch, t_attn, dev, encoder, decoder, cfg, queries, abstract, fg,
                     got_f32):
    """One 4096-query chunk of a decoder in precision='fast' on the card
    against the same decode with the plain bf16 versions on the card
    (plain_kernels): density within 2e-3, relative L2 of all channels within
    1e-3; the bf16 attention and interpolation kernels launched, no f32 one;
    the flips across 0.5 against the f32 kernel decode counted."""
    from occlusions4d_torch.evaluate import InferenceEngine
    from occlusions4d_torch.ops import _build
    eng = InferenceEngine(dict(encoder=encoder, decoder=decoder, device=dev), cfg.color_mode,
                          False, cfg.semantic_classes, track_mode='none',
                          implicit_batch_size=_CHECK_CHUNK, precision='fast')
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    got = eng.decode_all(queries, abstract, fg, fetch=False)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    with plain_kernels(torch, t_attn):
        ref = eng.decode_all(queries, abstract, fg, fetch=False)
    torch.cuda.synchronize()
    d_err = max_err(got[:, 0], ref[:, 0])
    l2 = rel_l2(got, ref)
    share, n, _, _ = flip_stats(got[:, 0], torch.tensor(got_f32[:, 0], device=dev))
    launched = (counts['attn_bf16'] == 2 and counts['interp_bf16'] == 1
                and all(counts[k] == 0 for k in _FAST_F32))
    ok = (d_err <= 2e-3 and l2 <= 1e-3 and launched and bool(torch.isfinite(got).all()))
    return dict(density_max_abs_err_vs_plain_bf16=d_err, rel_l2_vs_plain_bf16=l2,
                tolerance='density 2e-3, relative L2 1e-3',
                density_flip_share_vs_f32=share, density_flips_vs_f32=n,
                launches={k: counts[k] for k in _FAST + _FAST_F32}, ok=ok)


def decoder_wide(torch, t_attn, dev, smi):
    """Phase 11: decoders wider than one 416-column block of the attention
    forward tile, which the JAX CLI reaches with --pt_feat_dim 40 (D 448,
    E 320) and --global_size 256 (D 544, E 288). Per width, with seeded
    weights: the engine encodes a 14336-point cloud and decodes one
    4096-query chunk of the gv1 grid on the card, and the same chunk on the
    CPU (plain versions) from the card's abstract cloud must agree (density
    1e-4, as main_path_cv1); the first attention layer's kernels against
    their plain versions (wide_attention_lines). The same at gv1's D 416,
    one block wide, for comparison. At D 448: one Trainer step (batch 1,
    one frame) after a decoder gradient check against the CPU
    (decoder_grad_check's gate)."""
    import copy
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.evaluate import InferenceEngine
    from occlusions4d_torch.ops import blind_points_numpy
    from occlusions4d_torch.train import Trainer
    rng = np.random.RandomState(30)
    out = {}
    for name, kw in (('d448_e320', dict(pt_feat_dim=40)), ('d544_e288', dict(global_size=256)),
                     ('d416_e288', {})):
        cfg = TrainConfig(**dict(_GV1, **kw))
        encoder, decoder, dec_args = seeded_models(torch, cfg, dev, 31)
        engine = InferenceEngine(dict(encoder=encoder, decoder=decoder, device=dev),
                                 cfg.color_mode, False, cfg.semantic_classes,
                                 track_mode='none', implicit_batch_size=_CHECK_CHUNK)
        pcl = rng.rand(14336, 8).astype(np.float32) * 2 - 1
        queries = blind_points_numpy(_NUM_SAMPLE, cfg.min_z, cfg.cr_cube_bounds, 0,
                                     'greater', cfg.cube_mode, 'grid')[:_CHECK_CHUNK]
        abstract, fg = engine.encode(pcl)
        got = engine.decode_all(queries, abstract, fg, fetch=False)
        torch.cuda.synchronize()
        cpu = InferenceEngine(dict(encoder=None, decoder=copy.deepcopy(decoder).cpu(),
                                   device=torch.device('cpu')),
                              cfg.color_mode, False, cfg.semantic_classes,
                              track_mode='none', implicit_batch_size=_CHECK_CHUNK)
        ref = cpu.decode_all(queries, abstract.cpu(), fg.cpu())
        got = got.cpu().numpy()
        d_err = float(np.abs(got[:, 0] - ref[:, 0]).max())
        all_err = float(np.abs(got - ref).max())
        D = dec_args['d_latent']
        qxyz = torch.tensor(queries[None, :, :3].astype(np.float32), device=dev)
        lines = wide_attention_lines(torch, t_attn, dev, rng, name,
                                     decoder.pt_blocks[0].layer2.kernel_params(), qxyz,
                                     abstract)
        fast = fast_chunk_check(torch, t_attn, dev, encoder, decoder, cfg, queries, abstract,
                                fg, got)
        ok = (d_err <= 1e-4 and bool(np.isfinite(got).all())
              and list(abstract.shape) == [1, 531, 3 + dec_args['d_latent_local']])
        out[name] = dict(D=D, E=dec_args['d_latent_local'], density_max_abs_err_vs_cpu=d_err,
                         all_channels_max_abs_err_vs_cpu=all_err, ok=ok,
                         attention=lines, fast=fast)
        emit(dict(phase='decoder_wide', case=name, D=D, E=dec_args['d_latent_local'],
                  queries=_CHECK_CHUNK, density_max_abs_err_vs_cpu=d_err,
                  all_channels_max_abs_err_vs_cpu=all_err, tolerance='density 1e-4',
                  fast=fast, ok=ok and fast['ok'], gpu=smi))
        if not ok:
            raise AssertionError(f'decoder_wide {name}: error {d_err} vs the CPU')
        if not fast['ok']:
            raise AssertionError(f"decoder_wide {name}: precision='fast' failed: {fast}")
        del encoder, decoder, engine, cpu
        torch.cuda.empty_cache()
    # One Trainer step at D 448, batch 1, one frame.
    cfg = TrainConfig(**dict(_GV1_TRAIN, pt_feat_dim=40, batch_size=1, past_frames=1))
    tr = Trainer(cfg, 'greater', 'cuda')
    wrng = np.random.RandomState(32)
    tr.init_state(params=dict(encoder=random_jax_params(tr.encoder, wrng),
                              decoder=random_jax_params(tr.decoder, wrng)),
                  seed=0, steps_per_epoch=100)
    batch = train_batch(torch, cfg, dev, seed=33)
    with torch.no_grad():
        abstract, fg = tr.encoder(batch['pcl_input'], generator=tr.generator)
        frame = tr.pipeline.sample_frames(batch, tr.generator)[0]
    check = decoder_grad_check(torch, tr, abstract, fg, frame, dev, expect=_INDEX_ROUTE)
    before = [p.detach().clone() for p in tr.optimizer.params]
    t0 = time.time()
    m = tr.step(batch)
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) * 1e3
    changed = max(max_err(p, q) for p, q in zip(tr.optimizer.params, before))
    finite = (bool(np.isfinite(float(m['total_loss']))) and bool(m['grads_finite'])
              and bool(m['params_finite']))
    ok = check['ok'] and finite and changed > 0.0
    emit(dict(phase='decoder_wide', case='train_step_d448', D=448, E=320, batch_size=1,
              frames=1, step_ms=step_ms, total_loss=float(m['total_loss']),
              params_changed_max_abs=changed, decoder_grad_check=check, ok=ok, gpu=smi))
    if not ok:
        raise AssertionError(f'decoder_wide train step failed: {check}, finite {finite}, '
                             f'changed {changed}')
    out['train_step_d448'] = dict(step_ms=step_ms, decoder_grad_check=check)
    return out


# Phase train_data_parallel: gv1 at full width, global batch 4 as 2 ranks x
# 2 rows on one card over gloo (parallel.spawn with ['cuda:0', 'cuda:0']),
# held against the one-process batch-4 Trainer on the card from the same
# seeded weights, batch and fixed supervision (FPS from point 0); then one
# cv1 step of 2 ranks x 1 row; then train.main with two ranks on the card.
_DP_DEVICES = ['cuda:0', 'cuda:0']
_DP_TRAIN = dict(_GV1_TRAIN, batch_size=4)
_DP_CV1 = dict(_CV1_TRAIN, batch_size=2)
_DP_STEPS = 2                    # timed steps, after one warm-up step (3 before
#                                  the time budget's cut).
# Gates against the one-process run: logged scalars rtol 2e-5, parameter
# deltas 1e-4 relative L2 (the CPU test's 1e-5 / 1e-4, the scalars' doubled),
# or six times the one-process runs' largest distance from each other where
# that is larger.
# The card's backward sums are not bit-reproducible, and over 4 steps AdamW
# turns rounding in near-zero gradients into lr-size moves: on an NVIDIA
# H100 80GB HBM3 at 700 W two runs of this phase read 1.24e-5 / 3.3e-4 and
# 1.42e-5 / 3.2e-4 against one-process spreads of 5.1e-6 / 1.3e-4 and
# 5.0e-6 / 1.5e-4 (2.2-2.9 times), the CPU test's 3 tiny steps 3.5e-7 /
# 4.3e-5; every naive variant the CPU tests reject is off by 8.9e-3 or more.
_DP_RTOL, _DP_DELTA, _DP_NOISE = 2e-5, 1e-4, 6.0
_DP_ONE_RUNS = 3                 # one-process runs: the reference and two repeats.
# train.main over two ranks: one epoch of 4 steps of batch 4 (16 examples:
# the dataset's train stage holds 960 x use_data_frac of them).
_DP_MAIN_FRAC = str(16.5 / 960)


def dp_trainer(torch, cfg_kw, data_kind, seed, group=None):
    """A Trainer of cfg_kw (one rank of `group`, or one process on the
    card) from seeded weights, FPS from point 0, the CPU lockstep's fixed
    supervision (tests/torch_parallel_ranks.py) at the train frame's width
    in the cuboid."""
    sys.path.append(os.path.join(_HERE, 'tests'))
    from torch_parallel_ranks import FixedSampler, supervision
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.train import Trainer
    cfg = TrainConfig(**cfg_kw)
    tr = Trainer(cfg, data_kind, 'cuda', group=group)
    wrng = np.random.RandomState(seed)
    tr.init_state(params=dict(encoder=random_jax_params(tr.encoder, wrng),
                              decoder=random_jax_params(tr.decoder, wrng)),
                  seed=0, steps_per_epoch=100)
    tr.encoder.fps_random_start = False
    n_q = cfg.num_cr_solid + int(cfg.num_cr_solid * cfg.air_sampling_ratio)
    q, t = supervision(cfg.past_frames, n_q, cfg.cr_cube_bounds)
    tr.pipeline.sampler = FixedSampler(q, t, cfg.num_cr_solid)
    return tr


def dp_steps(torch, tr, batch):
    """1 warm-up + _DP_STEPS timed steps (launches counted over the timed
    ones), then one step split at its phase marks; the parameters after
    the timed steps. :return dict."""
    from occlusions4d_torch.ops import _build
    torch.cuda.reset_peak_memory_stats()
    warm = tr.step(batch)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    steps = [{k: (v.tolist() if v.dim() else v.item()) for k, v in warm.items()}]
    walls = []
    for _ in range(_DP_STEPS):
        t0 = time.time()
        m = tr.step(batch)
        torch.cuda.synchronize()
        walls.append((time.time() - t0) * 1e3)
        steps.append({k: (v.tolist() if v.dim() else v.item()) for k, v in m.items()})
    counts = _build.launch_counts()
    params = [p.detach().double().cpu().numpy().ravel() for p in tr.optimizer.params]
    split = split_step(torch, tr, batch)
    return dict(steps=steps, step_ms=walls, mean_step_ms=float(np.mean(walls)),
                split_ms=split, peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches=counts, params=np.concatenate(params))


def dp_rank(group, spec):
    """One rank of phase train_data_parallel (spawned: importable by name).
    Its rows of the seeded global batch through the gv1 steps, then one cv1
    step; rank 0 writes every rank's results to spec['out']."""
    import pickle
    import torch
    from occlusions4d_torch import parallel
    tr = dp_trainer(torch, _DP_TRAIN, 'greater', spec['seed'], group)
    batch = train_batch(torch, tr.cfg, group.device, seed=spec['seed'] + 1)
    res = dp_steps(torch, tr, parallel.shard_rows(batch, group.rank, group.size))
    del tr, batch
    torch.cuda.empty_cache()
    ctr = dp_trainer(torch, _DP_CV1, 'carla', spec['seed'] + 2, group)
    cbatch = train_batch(torch, ctr.cfg, group.device, seed=spec['seed'] + 3,
                         data_kind='carla')
    t0 = time.time()
    m = ctr.step(parallel.shard_rows(cbatch, group.rank, group.size))
    torch.cuda.synchronize()
    res['cv1'] = dict(ms=(time.time() - t0) * 1e3,
                      **{k: (v.tolist() if v.dim() else v.item()) for k, v in m.items()})
    res['rank'] = group.rank
    res['backend'] = group.backend
    everyone = [None] * group.size
    torch.distributed.all_gather_object(everyone, res)
    if group.is_main:
        with open(spec['out'], 'wb') as f:
            pickle.dump(everyone, f)


def stdout_to(path):
    """Send this process's file descriptor 1, and so the stdout of every
    process it starts, to `path` until the returned callable is called (the
    ranks' loggers write there; this script's standard output stays JSON)."""
    sys.stdout.flush()
    saved = os.dup(1)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    os.dup2(fd, 1)
    os.close(fd)

    def restore():
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)
    return restore


def dp_close(dp, one):
    """The logged scalars' largest difference of a run from the one-process
    run, step by step, relative to the rtol + atol gate's scale (2e-5 /
    2e-4 absolute) and so comparable to rtol."""
    worst = 0.0
    for a, b in zip(dp['steps'], one['steps']):
        for k in ('total_loss', 'loss_dens', 'loss_rgb', 'loss_track', 'grad_norm'):
            worst = max(worst, abs(a[k] - b[k]) / (abs(b[k]) + 0.1))
    return worst


def train_data_parallel(torch, dev, smi, path_counts, train_data):
    """Phase train_data_parallel (see _DP_DEVICES): the one-process batch-4
    gv1 run, then the 2-rank run (each rank's step wall, its all-reduce
    share and peak memory), held against it; the cv1 step; train.main over
    two ranks for one epoch and its checkpoint reloaded. :return {kernel:
    launches} of rank 0's timed steps."""
    import pickle
    import shutil
    import tempfile
    from occlusions4d_torch import parallel
    from occlusions4d_torch import train as t_train
    from occlusions4d_torch.config import train_args
    from occlusions4d_torch.evaluate import load_models
    seed = 31
    tmp = tempfile.mkdtemp(prefix='o4d_dp_')
    try:
        runs = []
        for _ in range(_DP_ONE_RUNS):
            tr = dp_trainer(torch, _DP_TRAIN, 'greater', seed)
            init = np.concatenate([p.detach().double().cpu().numpy().ravel()
                                   for p in tr.optimizer.params])
            batch = train_batch(torch, tr.cfg, dev, seed=seed + 1)
            runs.append(dp_steps(torch, tr, batch))
            del tr, batch
            torch.cuda.empty_cache()
        one = runs[0]
        spec = dict(seed=seed, out=os.path.join(tmp, 'ranks.pkl'))
        log_fp = os.path.join(_HERE, 'chiprun_out', 'train_data_parallel.log')
        open(log_fp, 'w').close()
        restore = stdout_to(log_fp)
        try:
            t0 = time.time()
            parallel.spawn(dp_rank, _DP_DEVICES, args=(spec,), run_dir=tmp, timeout=600)
            spawn_s = time.time() - t0
        finally:
            restore()
        with open(spec['out'], 'rb') as f:
            ranks = pickle.load(f)
        dp = ranks[0]
        scalar_rel = dp_close(dp, one)
        d_one, d_dp = one['params'] - init, dp['params'] - init
        delta_rel = float(np.linalg.norm(d_dp - d_one) / np.linalg.norm(d_one))
        pairs = [(a, b) for i, a in enumerate(runs) for b in runs[i + 1:]]
        repeat_scalar_rel = max(dp_close(a, b) for a, b in pairs)
        repeat_rel = max(float(np.linalg.norm(a['params'] - b['params'])
                               / np.linalg.norm(d_one)) for a, b in pairs)
        scalar_gate = max(_DP_RTOL, _DP_NOISE * repeat_scalar_rel)
        delta_gate = max(_DP_DELTA, _DP_NOISE * repeat_rel)
        equal_ranks = all(np.array_equal(r['params'], dp['params']) for r in ranks)
        per_rank = [dict(rank=r['rank'], step_ms=r['step_ms'], mean_step_ms=r['mean_step_ms'],
                         split_ms=r['split_ms'],
                         all_reduce_share=r['split_ms'].get('gradient_all_reduce', 0.0)
                         / sum(r['split_ms'].values()),
                         peak_mem_gib=r['peak_mem_gib'], cv1_step_ms=r['cv1']['ms'])
                    for r in ranks]
        launched = all(dp['launches'].get(k, 0) > 0 for k in _TRAIN)
        cv1_ok = all(math.isfinite(r['cv1']['total_loss']) and r['cv1']['grads_finite']
                     and r['cv1']['params_finite'] for r in ranks)
        finite = all(math.isfinite(st['total_loss']) and st['grads_finite']
                     and st['params_finite'] for r in ranks for st in r['steps'])
        path_counts['train_data_parallel'] = dp['launches']

        # train.main with --data_parallel 2's ranks, both on the card.
        argv = [a for a in _TD_GV1_ARGV] + [
            '--batch_size', '4', '--num_epochs', '1', '--use_data_frac', _DP_MAIN_FRAC,
            '--data_path', train_data, '--checkpoint_root', os.path.join(tmp, 'ck'),
            '--log_root', os.path.join(tmp, 'logs'), '--data_parallel', '2',
            '--worker_mode', 'process']
        cfg = train_args(argv)
        restore = stdout_to(log_fp)
        try:
            t0 = time.time()
            ret = t_train.main(cfg, devices=_DP_DEVICES)
            main_s = time.time() - t0
        finally:
            restore()
        ckpts = sorted(os.listdir(cfg.output_path))
        L = load_models(os.path.join(cfg.output_path, 'checkpoint.pkl'), device=dev)
        rtr = t_train.Trainer(cfg, 'greater', logger=quiet_logger(None, 'reload'))
        rtr.resume(os.path.join(cfg.output_path, 'checkpoint.pkl'), steps_per_epoch=4)
        reload_ok = (ret is None and ckpts == ['checkpoint.pkl', 'model_0.pkl']
                     and L['epoch'] == 0 and rtr.start_epoch == 1 and rtr.step_count == 4
                     and int(rtr.optimizer.count) == 4
                     and all(bool(torch.isfinite(p).all()) for p in rtr.optimizer.params))
        del L, rtr
        ok = (scalar_rel <= scalar_gate and delta_rel <= delta_gate and equal_ranks and launched
              and cv1_ok and finite and reload_ok
              and all(r['backend'] == 'gloo' for r in ranks))
        emit(dict(phase='train_data_parallel', model='gv1', devices=_DP_DEVICES,
                  backend=dp['backend'], global_batch=_DP_TRAIN['batch_size'],
                  rows_per_rank=_DP_TRAIN['batch_size'] // len(_DP_DEVICES),
                  one_process=dict(step_ms=one['step_ms'], mean_step_ms=one['mean_step_ms'],
                                   split_ms=one['split_ms'], peak_mem_gib=one['peak_mem_gib']),
                  ranks=per_rank, spawn_wall_s=spawn_s,
                  losses_dp=[st['total_loss'] for st in dp['steps']],
                  losses_one=[st['total_loss'] for st in one['steps']],
                  scalars_max_rel_diff=scalar_rel, scalars_gate=scalar_gate,
                  param_delta_rel_l2=delta_rel, param_delta_gate=delta_gate,
                  one_process_repeats=dict(runs=len(runs),
                                           scalars_max_rel_diff=repeat_scalar_rel,
                                           param_delta_rel_l2=repeat_rel,
                                           mean_step_ms=[r['mean_step_ms'] for r in runs]),
                  ranks_params_equal=equal_ranks, cv1_ok=cv1_ok,
                  cv1_losses=[r['cv1']['total_loss'] for r in ranks],
                  launches=dp['launches'], one_process_launches=one['launches'],
                  train_main_wall_s=main_s, train_main_checkpoints=ckpts,
                  checkpoint_reload_ok=reload_ok, ok=bool(ok), gpu=smi))
        if not ok:
            raise AssertionError(f'train_data_parallel failed: scalars {scalar_rel}, deltas '
                                 f'{delta_rel}, ranks equal {equal_ranks}, launched '
                                 f'{launched}, cv1 {cv1_ok}, finite {finite}, reload '
                                 f'{reload_ok}')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return path_counts['train_data_parallel']


def eval_query_parallel(torch, dev, smi, path_counts):
    """Phase eval_query_parallel: the gv1 dense scene (524288 grid queries)
    with InferenceEngine over two replicas on the card (devices ['cuda:0',
    'cuda:0']) against one device at the same chunk and at the replicas'
    per-device chunk, bit for bit, times printed; then the committed GREATER
    anchor through the eval driver with the 2-replica engine against the
    1-device driver, per-frame metrics equal. :return {kernel: launches} of
    the 2-replica scene."""
    import shutil
    import tempfile
    sys.path.append(os.path.join(_HERE, 'tests'))
    import anchor_recipe
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.evaluate import InferenceEngine
    from occlusions4d_torch.ops import _build, blind_points_numpy
    cfg = TrainConfig(**_GV1)
    encoder, decoder, _ = seeded_models(torch, cfg, dev, 1)
    loaded = dict(encoder=encoder, decoder=decoder, device=dev)
    pcl = np.random.RandomState(0).rand(14336, 8).astype(np.float32) * 2 - 1
    queries = blind_points_numpy(_NUM_SAMPLE, cfg.min_z, cfg.cr_cube_bounds, 0, 'greater',
                                 cfg.cube_mode, 'grid')
    engines = dict(
        one=InferenceEngine(loaded, cfg.color_mode, False, cfg.semantic_classes,
                            implicit_batch_size=_CHUNK),
        one_half_chunk=InferenceEngine(loaded, cfg.color_mode, False, cfg.semantic_classes,
                                       implicit_batch_size=_CHUNK // 2),
        replicas=InferenceEngine(loaded, cfg.color_mode, False, cfg.semantic_classes,
                                 implicit_batch_size=_CHUNK, devices=_DP_DEVICES))
    outs, times, counts = {}, {}, {}
    for name in ('one', 'replicas', 'one_half_chunk', 'replicas', 'one'):
        eng = engines[name]
        a, g = eng.encode(pcl)                      # warm-up, not timed.
        eng.decode_all(queries[:_CHUNK], a, g, fetch=False)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.time()
        a, g = eng.encode(pcl)
        out = eng.decode_all(queries, a, g, fetch=False)
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.time() - t0) * 1e3)
        counts[name] = _build.launch_counts()
        outs[name] = out
    same_chunk = bool(torch.equal(outs['replicas'], outs['one']))
    same_launch = bool(torch.equal(outs['replicas'], outs['one_half_chunk']))
    err = float((outs['replicas'] - outs['one']).abs().max())
    path_counts['eval_query_parallel'] = counts['replicas']
    launched = all(counts['replicas'].get(k, 0) > 0 for k in _INFER)
    del outs, engines
    torch.cuda.empty_cache()

    # The GREATER anchor through the eval driver, one device and two replicas.
    tmp = tempfile.mkdtemp(prefix='o4d_qp_')
    try:
        name = anchor_recipe.ANCHORS['greater']
        data = anchor_recipe.make_scene('greater', os.path.join(tmp, name))
        res = {}
        for run, devices in (('one', None), ('replicas', _DP_DEVICES)):
            log = os.path.join(tmp, name, run, 'anchor')
            argv, committed = anchor_recipe.eval_argv('greater', data, log,
                                                      ('--eval_precision', 'auto'))
            summary, c, wall, split = run_driver(torch, argv, log, devices=devices)
            res[run] = dict(summary=summary, wall=wall, launches=c,
                            within=all(d['within'] for d in metric_deltas(
                                summary['per_frame'], committed).values()))
        anchor_same = res['one']['summary']['per_frame'] == \
            res['replicas']['summary']['per_frame']
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok = (same_launch and (same_chunk or err <= 1e-5) and launched and anchor_same
          and res['replicas']['within'])
    emit(dict(phase='eval_query_parallel', model='gv1', devices=_DP_DEVICES,
              queries=int(queries.shape[0]), chunk=_CHUNK, scene_ms=times,
              bit_equal_one_device_same_chunk=same_chunk,
              bit_equal_one_device_same_launches=same_launch,
              max_abs_diff_same_chunk=err, launches=counts['replicas'],
              one_device_launches=counts['one'],
              anchor_frames=len(res['replicas']['summary']['per_frame']),
              anchor_per_frame_equal=anchor_same,
              anchor_within_committed=res['replicas']['within'],
              anchor_wall_s={k: v['wall'] for k, v in res.items()},
              ok=bool(ok), gpu=smi))
    if not ok:
        raise AssertionError(f'eval_query_parallel failed: same launches {same_launch}, same '
                             f'chunk {same_chunk} ({err}), launched {launched}, anchor '
                             f'{anchor_same}')
    return counts['replicas']


# ------------------------------------------- the train step's observability --
# Phase profile_trace: train.main on the gv1 recipe for one epoch of 5 train
# steps with --profile_steps 2 --watch_networks true.
_PROFILE_STEPS = 2
_PROFILE_FRAC = str(2.0 / 120)
# PERF.md section 5's host-clock proxies of the card's busy share of a gv1
# step (tools/profile_train_driver.py): loader-fed, preloaded.
_BUSY_PROXIES = dict(loader_fed=0.71, preloaded=0.91)
# The device-side operations of a torch.profiler trace.
_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
# Phase train_module_decoder: timed module-path steps; its gate against the
# fused path (the fused kernels' 3xTF32 products the only difference).
_MODULE_STEPS = 3
_MODULE_RTOL = 1e-4
_MODULE_NONE = ('attn', 'attn_bwd', 'interp', 'interp_bwd', 'gather', 'attn_g', 'scatter')
# Phase encoder_up: the gv1 encoder with its up path, d_out 6 (the
# reference's default; gv1's encoder_args carry d_out 1, which the up path's
# post_mlp, d_out - 3 wide, cannot take).
_UP_D_OUT = 6


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def trace_summary(path, n_top=8, n_gaps=3):
    """The device side of a torch.profiler Chrome trace: the busy share of
    the window from the first train step's span to the last device
    operation's end (and of the window between the first and the last
    device operation), the top device operations by time with their counts,
    the longest idle gaps, the train_step_<i> spans and every o4d_<kernel>
    span name (CPU or card timeline)."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    dev_ops = [e for e in events if e.get('cat') in _DEVICE_CATS and e.get('ph') == 'X']
    steps = sorted({e['name'] for e in events if e.get('cat') == 'user_annotation'
                    and str(e.get('name', '')).startswith('train_step_')})
    spans = sorted({e['name'] for e in events
                    if e.get('cat') in ('user_annotation', 'gpu_user_annotation')
                    and str(e.get('name', '')).startswith('o4d_')})
    out = dict(file=os.path.basename(path), bytes=os.path.getsize(path), steps=steps,
               o4d_spans=spans, device_ops=len(dev_ops))
    if not dev_ops:
        return out
    ivs = sorted((float(e['ts']), float(e['ts']) + float(e['dur']), e['name'])
                 for e in dev_ops)
    merged = []
    for a, b, name in ivs:
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1], merged[-1][3] = b, name
        else:
            merged.append([a, b, name, name])
    busy = sum(b - a for a, b, _, _ in merged)
    step1 = [float(e['ts']) for e in events if e.get('cat') == 'user_annotation'
             and e.get('name') == 'train_step_1']
    start = min(step1) if step1 else merged[0][0]
    window = merged[-1][1] - start
    span = merged[-1][1] - merged[0][0]
    by_name = {}
    for a, b, name in ivs:
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + b - a, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n_top]
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1] - start, merged[i][3],
                    merged[i + 1][2]) for i in range(len(merged) - 1)), reverse=True)[:n_gaps]
    out.update(
        window_ms=window / 1e3, busy_ms=busy / 1e3, busy_share=busy / window,
        busy_share_first_to_last_op=busy / span,
        top_ops=[dict(name=n[:120], ms=t / 1e3, count=c) for n, (t, c) in top],
        idle_gaps=[dict(ms=g / 1e3, at_ms=at / 1e3, after=a[:120], before=b[:120])
                   for g, at, a, b in gaps])
    return out


def profile_trace(torch, dev, smi, path_counts, train_data):
    """Phase profile_trace: train.main on the gv1 recipe (one epoch of 5
    train steps) with --profile_steps 2 --watch_networks true: the trace
    under <log_dir>/profile covers train steps 1-2 and names o4d_attn,
    o4d_attn_bwd and o4d_knn_brute; its device-busy share, top device
    operations and idle gaps; one per-layer norm per parameter tensor, all
    finite; then the step wall with and without the norms on the run's
    Trainer and a preloaded batch."""
    import glob
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix='o4d_profile_')
    try:
        argv = _TD_GV1_ARGV + ['--data_path', train_data, '--checkpoint_root',
                               os.path.join(tmp, 'ck'), '--num_epochs', '1',
                               '--use_data_frac', _PROFILE_FRAC,
                               '--profile_steps', str(_PROFILE_STEPS),
                               '--watch_networks', 'true']
        tr, counts, wall, epochs = driver_run(torch, argv, os.path.join(tmp, 'logs'))
        path_counts['profile_trace'] = counts
        files = glob.glob(os.path.join(tr.logger.log_dir, 'profile', '*.pt.trace.json'))
        trace = trace_summary(files[0]) if len(files) == 1 else {}
        train_e = [e for e in epochs if e['stage'] == 'train']
        row = tr.logger.scalar_history[0]
        g = [v for k, v in row.items() if k.startswith('train/grad_norm/')]
        p = [v for k, v in row.items() if k.startswith('train/param_norm/')]
        n_params = len(tr.optimizer.params)
        norms_ok = (len(g) == len(p) == n_params == len(tr.layer_names)
                    and all(math.isfinite(v) for v in g + p))
        # The step with and without the norms, A B B A, on a preloaded batch.
        batch = train_batch(torch, tr.cfg, dev)
        walls = {'with': [], 'without': []}
        for want in (True, False, False, True):
            torch.cuda.synchronize()
            t0 = time.time()
            m = tr.step(batch, want_norms=want)
            if want:
                m['layer_grad_norms'].cpu(), m['layer_param_norms'].cpu()
            torch.cuda.synchronize()
            walls['with' if want else 'without'].append((time.time() - t0) * 1e3)
        need = ('o4d_attn', 'o4d_attn_bwd', 'o4d_knn_brute')
        ok = (len(files) == 1 and trace.get('steps') == ['train_step_1', 'train_step_2']
              and all(n in trace.get('o4d_spans', ()) for n in need)
              and trace.get('device_ops', 0) > 0 and norms_ok
              and train_e and train_e[0]['steps'] >= 4
              and all(counts.get(k, 0) > 0 for k in _TRAIN))
        emit(dict(phase='profile_trace', model='gv1', argv_extra=argv[len(_TD_GV1_ARGV):],
                  trace_files=len(files), trace=trace,
                  busy_share_proxies_perf_md=_BUSY_PROXIES, train_steps=train_e[0]['steps']
                  if train_e else 0, epochs=epochs, wall_s=wall,
                  layer_norms=dict(parameters=n_params, grad_norms=len(g),
                                   param_norms=len(p), finite=norms_ok,
                                   grad_norm_max=max(g) if g else None),
                  step_ms_with_norms=walls['with'], step_ms_without_norms=walls['without'],
                  launches=nonzero(counts), ok=bool(ok), gpu=smi))
        if not ok:
            raise AssertionError(f'profile_trace failed: trace files {files}, steps '
                                 f'{trace.get("steps")}, spans {trace.get("o4d_spans")}, '
                                 f'device ops {trace.get("device_ops")}, norms {norms_ok}')
        del tr, batch
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def seeded_trainer(torch, cfg, seed=2):
    """A Trainer on the card with seeded numpy weights (the train phase's)."""
    from occlusions4d_torch.train import Trainer
    tr = Trainer(cfg, 'greater', 'cuda')
    wrng = np.random.RandomState(seed)
    tr.init_state(params=dict(encoder=random_jax_params(tr.encoder, wrng),
                              decoder=random_jax_params(tr.decoder, wrng)),
                  seed=0, steps_per_epoch=100)
    return tr


def decoder_loss_grads(torch, tr, batch, dev):
    """The pipeline's loss and its decoder gradients from one seeded draw."""
    params = list(tr.decoder.parameters())
    loss, _ = tr.pipeline.loss(batch, torch.Generator(dev).manual_seed(11))
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), [g.detach() for g in grads]


def train_module_decoder(torch, dev, smi, path_counts):
    """Phase train_module_decoder: the gv1 train step (batch 3, 4 frames,
    full width) with --fused_decoder off, remat on: from one state and one
    draw, the loss and the decoder's gradients against the fused path's
    (rel 1e-4: the global gradient norm; each parameter's gradient norm
    printed); 1 warm-up + 3 timed steps (their launches: the kNN kernels,
    no fused decoder kernel), peak memory, one phase-split step; then the
    step with remat off, or its out-of-memory error."""
    import gc
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.ops import _build
    cfg = TrainConfig(**_GV1_TRAIN)
    batch = train_batch(torch, cfg, dev)
    fused = seeded_trainer(torch, cfg)
    f_loss, f_grads = decoder_loss_grads(torch, fused, batch, dev)
    f_norms = [float(g.norm()) for g in f_grads]
    f_total = math.sqrt(sum(n * n for n in f_norms))
    del fused, f_grads
    torch.cuda.empty_cache()
    tr = seeded_trainer(torch, TrainConfig(**_GV1_TRAIN, fused_decoder='off'))
    torch.cuda.reset_peak_memory_stats()
    m_loss, m_grads = decoder_loss_grads(torch, tr, batch, dev)
    grad_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    m_norms = [float(g.norm()) for g in m_grads]
    m_total = math.sqrt(sum(n * n for n in m_norms))
    del m_grads
    loss_rel = abs(m_loss - f_loss) / abs(f_loss)
    norm_rel = abs(m_total - f_total) / f_total
    per_param = [abs(a - b) / b for a, b in zip(m_norms, f_norms) if b > 1e-3 * f_total]
    steps, counts, changed, peak_gb, split, warm_ms = run_train_phase(torch, tr, batch,
                                                                      _MODULE_STEPS)
    path_counts['train_module_decoder'] = counts
    # Without remat: every frame's attention intermediates kept for the
    # backward.
    tr.pipeline.remat = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.time()
        m = tr.step(batch)
        torch.cuda.synchronize()
        no_remat = dict(ms=(time.time() - t0) * 1e3, finite=bool(m['grads_finite']),
                        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    except torch.cuda.OutOfMemoryError as e:
        no_remat = dict(out_of_memory=True, error=str(e).splitlines()[0][:300],
                        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    finally:
        tr.pipeline.remat = True
        gc.collect()
        torch.cuda.empty_cache()
    launched = (counts.get('knn_brute', 0) > 0 and counts.get('knn_pruned', 0) > 0
                and counts.get('fps_cluster', 0) > 0
                and all(counts.get(k, 0) == 0 for k in _MODULE_NONE))
    finite = all(np.isfinite(st['total_loss']) and st['grads_finite'] and st['params_finite']
                 for st in steps)
    ok = (loss_rel <= _MODULE_RTOL and norm_rel <= _MODULE_RTOL and launched and finite
          and changed > 0.0 and not tr.pipeline.fused_decoder)
    emit(dict(phase='train_module_decoder', model='gv1', batch_size=cfg.batch_size,
              frames=cfg.past_frames, fused_decoder='off', remat=True,
              loss_fused=f_loss, loss_module=m_loss, loss_rel_diff=loss_rel,
              decoder_grad_norm_fused=f_total, decoder_grad_norm_module=m_total,
              decoder_grad_norm_rel_diff=norm_rel, tolerance=f'rel {_MODULE_RTOL}',
              per_param_grad_norm_max_rel_diff=max(per_param) if per_param else None,
              grad_check_peak_mem_gib=grad_peak, warmup_ms=warm_ms,
              step_ms=[st['ms'] for st in steps],
              mean_step_ms=float(np.mean([st['ms'] for st in steps])), split_ms=split,
              peak_mem_gib=peak_gb, launches=nonzero(counts),
              launches_per_step={k: v / _MODULE_STEPS for k, v in counts.items() if v},
              params_changed_max_abs=changed, no_remat=no_remat, ok=bool(ok), gpu=smi))
    if not ok:
        raise AssertionError(f'train_module_decoder failed: loss rel {loss_rel}, grad norm '
                             f'rel {norm_rel}, launches {counts}, finite {finite}')
    del tr, batch


def check_numerics(torch, dev, smi, path_counts):
    """Phase check_numerics: the gv1 step at batch 1 with --check_numerics
    (the module paths, remat off, the probes): a clean train, val_aug and
    viz step pass; a NaN pcl_input raises naming pcl_input; a NaN weight of
    the decoder's output layer raises naming decoder_output_frame0; the
    step's time beside the batch-1 step without the flag (A B B A)."""
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.ops import _build
    kw = dict(_GV1_TRAIN, batch_size=1)
    tr = seeded_trainer(torch, TrainConfig(**kw, check_numerics=True))
    batch = train_batch(torch, TrainConfig(**kw), dev)
    paths_ok = (not tr.pipeline.fused_decoder and not tr.pipeline.remat
                and tr.pipeline.debug_checks and tr.fused_attention == 'off')
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    m = tr.step(batch)
    ev = tr._eval_step(batch, torch.Generator(dev).manual_seed(1))
    viz = tr._viz_step(batch, torch.Generator(dev).manual_seed(1))
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    path_counts['check_numerics'] = counts
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    clean = (bool(m['grads_finite']) and math.isfinite(float(m['total_loss']))
             and math.isfinite(float(ev['total_loss']))
             and bool(torch.isfinite(viz['implicit_output']).all()))
    raised = {}
    bad = dict(batch, pcl_input=torch.full_like(batch['pcl_input'], float('nan')))
    w = tr.decoder.lin_out.weight
    saved = float(w[0, 0].detach())
    for case, b in (('nan_pcl_input', bad), ('nan_decoder_weight', batch)):
        if case == 'nan_decoder_weight':
            with torch.no_grad():
                w[0, 0] = float('nan')
        try:
            tr.step(b)
            raised[case] = None
        except RuntimeError as e:
            raised[case] = str(e)
        finally:
            with torch.no_grad():
                w[0, 0] = saved
    ref = seeded_trainer(torch, TrainConfig(**kw))
    ms = {'check_numerics': [], 'without': []}
    for name, t in (('check_numerics', tr), ('without', ref), ('without', ref),
                    ('check_numerics', tr)):
        torch.cuda.synchronize()
        t0 = time.time()
        t.step(batch)
        torch.cuda.synchronize()
        ms[name].append((time.time() - t0) * 1e3)
    ok = (paths_ok and clean
          and raised['nan_pcl_input'] == 'NaN/Inf detected in pcl_input'
          and raised['nan_decoder_weight'] == 'NaN/Inf detected in decoder_output_frame0')
    emit(dict(phase='check_numerics', model='gv1', batch_size=1, frames=kw['past_frames'],
              module_paths_remat_off=paths_ok, clean_train_val_aug_viz=clean,
              raised=raised, step_ms_check_numerics=ms['check_numerics'],
              step_ms_without=ms['without'], peak_mem_gib=peak_gb, launches=nonzero(counts),
              ok=bool(ok), gpu=smi))
    if not ok:
        raise AssertionError(f'check_numerics failed: paths {paths_ok}, clean {clean}, '
                             f'raised {raised}')
    del tr, ref, batch


def store_activations(torch, dev, smi, path_counts):
    """Phase store_activations: (a) the gv1 dense grid (534528 queries) with
    the seeded weights of phase 4 through InferenceEngine(store_activations=
    True), f32 and 'fast': the outputs bit-equal to the engine's without
    the flag, the activations (N, 416) float16, finite, in query order (a
    chunk-aligned slice decoded alone gives its rows), the added ms; (b) the
    GREATER anchor through the eval driver (its first step) with and
    without --store_activations: activations_s*.p with one (solid rows,
    d_hidden) float16 array a frame, metrics.json equal."""
    import glob
    import pickle
    import shutil
    import tempfile
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.evaluate import InferenceEngine
    from occlusions4d_torch.ops import _build, blind_points_numpy
    cfg = TrainConfig(**_GV1)
    encoder, decoder, dec_args = seeded_models(torch, cfg, dev, 1)
    loaded = dict(encoder=encoder, decoder=decoder, device=dev)
    pcl = np.random.RandomState(0).rand(14336, 8).astype(np.float32) * 2 - 1
    queries = blind_points_numpy(_NUM_SAMPLE, cfg.min_z, cfg.cr_cube_bounds, 0, 'greater',
                                 cfg.cube_mode, 'grid')
    part = slice(3 * _CHUNK, 4 * _CHUNK)
    grid, counts_all = {}, {}
    for precision in ('f32', 'fast'):
        plain = InferenceEngine(loaded, cfg.color_mode, False, cfg.semantic_classes,
                                implicit_batch_size=_CHUNK, precision=precision)
        sa = InferenceEngine(loaded, cfg.color_mode, False, cfg.semantic_classes,
                             implicit_batch_size=_CHUNK, precision=precision,
                             store_activations=True)
        ab, fg = plain.encode(pcl)
        plain.decode_all(queries[:_CHUNK], ab, fg, fetch=False)        # warm-ups.
        sa.decode_all(queries[:_CHUNK], ab, fg, fetch=False)
        torch.cuda.synchronize()
        t0 = time.time()
        out = plain.decode_all(queries, ab, fg, fetch=False)
        torch.cuda.synchronize()
        t1 = time.time()
        _build.reset_launch_counts()
        out_sa, pen = sa.decode_all(queries, ab, fg, fetch=False)
        torch.cuda.synchronize()
        t2 = time.time()
        counts = _build.launch_counts()
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v
        _, pen_part = sa.decode_all(queries[part], ab, fg, fetch=False)
        torch.cuda.synchronize()
        grid[precision] = dict(
            decode_ms=(t1 - t0) * 1e3, decode_ms_store_activations=(t2 - t1) * 1e3,
            added_ms=(t2 - t1 - (t1 - t0)) * 1e3, bit_equal=bool(torch.equal(out, out_sa)),
            shape=list(pen.shape), dtype=str(pen.dtype).replace('torch.', ''),
            finite=bool(torch.isfinite(pen).all()),
            in_query_order=bool(torch.equal(pen_part, pen[part])),
            solid=int((out[:, 0] >= 0.5).sum()), launches=nonzero(counts))
        del out, out_sa, pen, pen_part
    path_counts['store_activations'] = counts_all
    grid_ok = all(g['bit_equal'] and g['finite'] and g['in_query_order']
                  and g['shape'] == [queries.shape[0], dec_args['d_hidden']]
                  and g['dtype'] == 'float16' for g in grid.values())
    # (b) The GREATER anchor through the eval driver, with and without.
    sys.path.append(os.path.join(_HERE, 'tests'))
    import anchor_recipe
    tmp = tempfile.mkdtemp(prefix='o4d_sa_')
    try:
        data = anchor_recipe.make_scene('greater', tmp)
        runs = {}
        for flag in ('true', 'false'):
            argv, _ = anchor_recipe.eval_argv(
                'greater', data, os.path.join(tmp, flag, 'anchor'),
                ('--store_activations', flag), steps=1)
            runs[flag] = run_driver(torch, argv, None)
        files = sorted(glob.glob(os.path.join(tmp, 'true', 'test_*', 'activations_s*.p')))
        pcls = sorted(glob.glob(os.path.join(tmp, 'true', 'test_*', 'pcl_io_s*.p')))
        none = glob.glob(os.path.join(tmp, 'false', 'test_*', 'activations_s*.p'))
        shapes, dtypes, rows_ok = [], set(), len(files) == len(pcls) > 0
        for fa, fp in zip(files, pcls):
            with open(fa, 'rb') as f:
                acts = pickle.load(f)
            with open(fp, 'rb') as f:
                recs = pickle.load(f)
            rows_ok = rows_ok and len(acts) == len(recs)
            for a, rec in zip(acts, recs):
                shapes.append(list(a.shape))
                dtypes.add(str(a.dtype))
                rows_ok = rows_ok and a.shape[0] == len(rec[2])
        widths = {s[1] for s in shapes}
        metrics_equal = (runs['true'][0]['per_frame'] == runs['false'][0]['per_frame']
                         and runs['true'][0]['mean'] == runs['false'][0]['mean'])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    anchor_ok = rows_ok and dtypes == {'float16'} and len(widths) == 1 and not none \
        and metrics_equal
    ok = grid_ok and anchor_ok
    emit(dict(phase='store_activations', model='gv1', queries=int(queries.shape[0]),
              chunk=_CHUNK, grid=grid, anchor=dict(
                  files=[os.path.basename(f) for f in files], frame_shapes=shapes,
                  dtypes=sorted(dtypes), width=sorted(widths), rows_match_solid=rows_ok,
                  metrics_json_equal=metrics_equal, wall_s={k: v[2] for k, v in runs.items()},
                  files_without_flag=len(none)),
              launches=nonzero(counts_all), ok=bool(ok), gpu=smi))
    if not ok:
        raise AssertionError(f'store_activations failed: grid {grid}, anchor rows {rows_ok}, '
                             f'dtypes {dtypes}, widths {widths}, metrics equal '
                             f'{metrics_equal}')


class plain_encoder_kernels:
    """Inside, the encoder's kNN (brute and pruned entries) and FPS kernels
    are swapped for their plain versions on the card; outside and inside,
    every result of those entry points is recorded in `calls` (name,
    indices)."""

    def __init__(self, torch, t_knn, t_fps, plain):
        self.t_knn, self.t_fps, self.plain, self.calls, self.saved = (t_knn, t_fps, plain,
                                                                       [], {})

    def __enter__(self):
        k, f = self.t_knn, self.t_fps
        self.saved = dict(brute=k._brute_cuda, pruned=k._pruned_cuda, fps=f._fps_cuda)
        calls, plain, saved = self.calls, self.plain, self.saved

        def brute(q, keys, kn, kk):
            d, i = k.knn_rank_plain(q, keys, kn, kk) if plain else saved['brute'](q, keys,
                                                                                    kn, kk)
            calls.append(('knn', i))
            return d, i

        def pruned(q, keys, kn, kk, same, visited=None):
            d, i = k.knn_rank_plain(q, keys, kn, kk) if plain else saved['pruned'](
                q, keys, kn, kk, same, visited)
            calls.append(('knn', i))
            return d, i

        def fps(xyz, n_out, valid, start_idx, plan=None):
            sel = f.fps_plain(xyz, n_out, valid, start_idx) if plain else saved['fps'](
                xyz, n_out, valid, start_idx, plan)
            calls.append(('fps', sel))
            return sel
        k._brute_cuda, k._pruned_cuda, f._fps_cuda = brute, pruned, fps
        return self

    def __exit__(self, *exc):
        k, f = self.t_knn, self.t_fps
        k._brute_cuda, k._pruned_cuda = self.saved['brute'], self.saved['pruned']
        f._fps_cuda = self.saved['fps']


def encoder_up(torch, t_knn, t_fps, dev, smi, path_counts):
    """Phase encoder_up: PointEncoder(enable_decoder=True, skip_connections=
    True) at gv1 widths (3 down and 3 up levels, d_out 6) with seeded
    weights, on a 14336-point cloud, eval mode: against the same encoder on
    the card with the kNN and FPS kernels swapped for their plain versions,
    every FPS and kNN index exact, the outputs within 1e-5; the kernels'
    run launches knn_brute or knn_pruned (UpTransition's k 3 searches
    included) and FPS."""
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.models import build_models
    from occlusions4d_torch.models.encoder import PointEncoder
    from occlusions4d_torch.ops import _build
    _, _, enc_args, _ = build_models(TrainConfig(**_GV1))
    enc = PointEncoder(**dict(enc_args, enable_decoder=True, skip_connections=True,
                              d_out=_UP_D_OUT, fps_random_start=False))
    from occlusions4d_torch.checkpoint import from_jax_params
    enc.load_state_dict(from_jax_params(random_jax_params(enc, np.random.RandomState(12)),
                                        enc), strict=True)
    enc = enc.to(dev).eval()
    pcl = torch.tensor(np.random.RandomState(13).rand(1, 14336, 8).astype(np.float32) * 2
                       - 1, device=dev)
    res = {}
    for name, plain in (('kernels', False), ('plain', True)):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.time()
        with torch.no_grad(), plain_encoder_kernels(torch, t_knn, t_fps, plain) as rec:
            out, g, coords = enc(pcl, return_intermediate=True)
        torch.cuda.synchronize()
        res[name] = dict(out=out, g=g, coords=coords, calls=rec.calls,
                         ms=(time.time() - t0) * 1e3, launches=_build.launch_counts())
    path_counts['encoder_up'] = res['kernels']['launches']
    k, p = res['kernels'], res['plain']
    same_calls = len(k['calls']) == len(p['calls']) and all(
        a[0] == b[0] and torch.equal(a[1], b[1]) for a, b in zip(k['calls'], p['calls']))
    coords_equal = all(torch.equal(a, b) for a, b in zip(k['coords'], p['coords']))
    err = max(max_err(k['out'], p['out']), max_err(k['g'], p['g']))
    c = k['launches']
    launched = (c.get('knn_brute', 0) + c.get('knn_pruned', 0) > 0
                and c.get('fps', 0) + c.get('fps_cluster', 0) > 0)
    plain_none = all(v == 0 for kk, v in p['launches'].items()
                     if kk in ('knn_brute', 'knn_pruned', 'fps', 'fps_cluster'))
    ok = (same_calls and coords_equal and err <= 1e-5 and launched and plain_none
          and list(k['out'].shape) == [1, 14336, _UP_D_OUT]
          and bool(torch.isfinite(k['out']).all()))
    emit(dict(phase='encoder_up', model='gv1', n_points=14336, d_out=_UP_D_OUT,
              up_blocks=enc_args['up_blocks'], out_shape=list(k['out'].shape),
              knn_calls=sum(1 for n, _ in k['calls'] if n == 'knn'),
              fps_calls=sum(1 for n, _ in k['calls'] if n == 'fps'),
              indices_exact=same_calls, layer_positions_equal=coords_equal,
              max_abs_err=err, tolerance='indices exact, outputs atol 1e-5',
              ms=k['ms'], plain_ms=p['ms'], launches=nonzero(c), plain_launches=nonzero(p['launches']),
              ok=bool(ok), gpu=smi))
    if not ok:
        raise AssertionError(f'encoder_up failed: indices {same_calls}, positions '
                             f'{coords_equal}, err {err}, launches {c}')


# The phases after the kernel lines, in their order (python3 chip_smoke.py
# --phases a,b runs the named ones only, with those they need).
PHASES = ('main_path', 'main_path_cv1', 'main_path_fast', 'anchor', 'eval_driver',
          'train_driver', 'reference_pth', 'train_batchnorm', 'train_loader_workers',
          'train_data_parallel', 'eval_query_parallel', 'train', 'sampler_moving',
          'train_cv1', 'train_bf16', 'train_sattn', 'train_57k', 'train_mixed',
          'decoder_wide', 'profile_trace', 'train_module_decoder', 'check_numerics',
          'store_activations', 'encoder_up')
# What a phase reads from an earlier one: main_path_fast holds the two f32
# scenes against its 'fast' ones; sampler_moving steps the train phase's
# Trainer and batch.
_PHASE_NEEDS = {'main_path_fast': ('main_path', 'main_path_cv1'),
                'sampler_moving': ('train',)}
# The phases whose launches every {"kernels"} row also shows, beside its path's.
_PHASE_COLUMNS = ('eval_driver', 'train_driver', 'train_data_parallel',
                  'eval_query_parallel', 'profile_trace', 'train_module_decoder',
                  'check_numerics', 'store_activations', 'encoder_up')


def phases_to_run(only):
    """The phases of a --phases list (None: all), with what they need, in
    PHASES order; an unknown name raises ValueError."""
    if not only:
        return PHASES
    unknown = [n for n in only if n not in PHASES]
    if unknown:
        raise ValueError(f'unknown phases {unknown}; the phases are {list(PHASES)}')
    want = set(only)
    for n in only:
        want.update(_PHASE_NEEDS.get(n, ()))
    return tuple(n for n in PHASES if n in want)


def parse_phases(argv):
    """--phases name[,name...] of the command line, or None."""
    import argparse
    parser = argparse.ArgumentParser(description='Smoke test of the PyTorch/CUDA port.')
    parser.add_argument('--phases', default=None,
                        help='comma-separated phases to run after the kernel lines '
                             f'(default: all): {",".join(PHASES)}')
    args = parser.parse_args(argv)
    if args.phases is None:
        return None
    only = tuple(n.strip() for n in args.phases.split(',') if n.strip())
    phases_to_run(only)
    return only


def main(only=None):
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
    import copy
    import importlib
    from occlusions4d_torch import environment
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.evaluate import InferenceEngine, load_models, \
        perform_inference
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

    # K1 brute force: the encoder's searches, the decoder's per-chunk search
    # (grid-ordered and random queries) and its train frames.
    knn_brute_lines(torch, t_knn, dev, rows)

    # K1' pruned: the level-0 self-search, the sampler's air rejections, the
    # n57344 level-0 self-search; then the brute/pruned crossover.
    pts = cloud(14336)
    q, kk, kn = prep(pts, pts)
    rows['knn_pruned'] = knn_pruned_line(torch, t_knn, dev, 'gv1_level0', q, kk, kn, 16,
                                         True)
    q, kk, kn = sampler_like(torch, t_knn, dev, np.random.RandomState(23), 3, 6996, 28672)
    rows['knn_pruned']['sampler'] = knn_pruned_line(torch, t_knn, dev, 'sampler_air', q, kk,
                                                    kn, 1, False)
    q, kk, kn = prep(*(cloud(57344),) * 2)
    rows['knn_pruned']['n57344_level0'] = knn_pruned_line(torch, t_knn, dev,
                                                          'n57344_level0', q, kk, kn, 16, True)
    del q, kk, kn
    knn_crossover_line(torch, t_knn, dev, np.random.RandomState(24))

    # K2 FPS (the cluster launches): the three DownTransitions at B 1
    # (inference) and 3 (train), the n57344 step's second level, and a cloud
    # above 153600 points (once the cap of a cluster holding the points in
    # shared memory).
    for (B, N, n_out) in ((1, 14336, 4779), (3, 14336, 4779), (1, 4779, 1593),
                          (3, 4779, 1593), (1, 1593, 531), (3, 1593, 531), (1, 19115, 6372),
                          (1, 200000, 2048)):
        fps_line(torch, t_fps, dev, rng, B, N, n_out)
    # The one-block launch, which the speed rule keeps for 512 points or fewer.
    rows['fps'] = fps_line(torch, t_fps, dev, rng, 3, 512, 171)
    # K2': the cluster entry at the n57344 encoder's first level.
    check_fps_cluster(torch, t_fps, dev, np.random.RandomState(20), rows)

    # K3 / K4 on one decode chunk with the gv1 decoder's attention weights.
    cfg = TrainConfig(**_GV1)
    encoder, decoder, dec_args = seeded_models(torch, cfg, dev, 1)
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
    e_ms = interp_entry_ms(torch, t_attn, 'interp', ki, kd, feats2, 8)
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
              ms=ms, entry_ms=e_ms, plain_ms=plain_ms, library_ms=lib_ms,
              bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
              entry_share_of_bound=b_ms / e_ms, queries='random',
              parent_ms_perf_md=_PARENT_MS.get('interp:random'),
              parent_entry_ms_perf_md=_PARENT_ENTRY_MS.get('interp:random')))
    if not ok:
        raise AssertionError(f'interp disagrees: max abs err {err}')
    rows['interp'] = dict(max_abs_err=err, ms=ms, entry_ms=e_ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                          shape=[_CHUNK, 531, 8, E])
    # Its bf16 mode on the same inputs (the features rounded as they load).
    bf = torch.bfloat16
    fb = t_attn.round_bf16(feats2)
    rows['interp_bf16'] = interp_bf16_line(
        torch, 'interp_bf16', lambda: t_attn.fused_knn_interp(qpos, pos2, feats2, 8,
                                                              knn=(ki, kd), compute_dtype=bf),
        lambda: t_attn.interp_plain(ki, kd, feats2, 8, 1e-4, bf),
        lambda: torch.nn.functional.embedding_bag(ki8, fb[0], per_sample_weights=w,
                                                  mode='sum'),
        'embedding_bag of the bf16-rounded features (the rounding not timed)',
        b_ms, b_by, [_CHUNK, 531, 8, E], ms, 2.0 * _CHUNK * 8 * E,
        entry=lambda: interp_entry_ms(torch, t_attn, 'interp_bf16', ki, kd, feats2, 8),
        parent=_PARENT_MS.get('interp_bf16:random'),
        parent_entry=_PARENT_ENTRY_MS.get('interp_bf16:random'))
    grid = interp_grid_line(torch, t_attn, dev, pos2, feats2)
    for name in ('interp', 'interp_bf16'):
        rows[name]['ms_grid'] = grid[name]['ms']
        rows[name]['entry_ms_grid'] = grid[name]['entry_ms']

    att = decoder.pt_blocks[0].layer2
    params = att.kernel_params()
    q_proj = torch.tensor(rng.randn(1, _CHUNK, D).astype(np.float32), device=dev)
    H, P = 2 * D, 32
    for premul in (True, False):
        with torch.no_grad():
            kv = (torch.cat([feats2 @ params['to_k']['kernel'],
                             feats2 @ params['to_v']['kernel']], -1).contiguous()
                  if premul else feats2)
        call = lambda: t_attn._attn_cuda(qpos, q_proj, ki, pos2, kv, params, 14,  # noqa: E731
                                         premul)
        plain = lambda: t_attn.attn_plain(qpos, q_proj, ki, pos2, kv, params, 14,  # noqa: E731
                                          premul)
        # Keys: the 531 rows' kv and positions; plus the (N, 14) indices.
        macs, nbytes = attn_fwd_work(_CHUNK * 14, _CHUNK, 531, 3 + kv.shape[-1], D, E, H, P,
                                     not premul)
        name = 'attn' if premul else 'attn_per_row'
        row, _ = attn_fwd_line(torch, name, call, plain, macs, nbytes + _CHUNK * 14 * 4,
                               [_CHUNK, 531, 14, D, E])
        # The bf16 mode on the same inputs, against its plain bf16 version.
        row_bf, _ = attn_fwd_line(
            torch, name.replace('attn', 'attn_bf16'),
            lambda: t_attn._attn_cuda(qpos, q_proj, ki, pos2, kv, params, 14, premul, True),
            lambda: t_attn.attn_plain(qpos, q_proj, ki, pos2, kv, params, 14, premul, bf),
            macs, nbytes + _CHUNK * 14 * 4, [_CHUNK, 531, 14, D, E], bf16=True,
            f32_call=call, f32_ms=row['ms'])
        if premul:
            rows['attn'], rows['attn_bf16'] = row, row_bf
        else:
            rows['attn']['per_row'], rows['attn_bf16']['per_row'] = row, row_bf

    # K5 / K6 / K7: the backward kernels and the bidirectional 1-NN.
    check_backward_kernels(torch, t_attn, t_knn, dev, rng, params, E, rows)
    # The eval labels' 1-NN at CARLA scale: the 541314-query grid against a
    # 100000-point frame in the same cuboid.
    grid = blind_points_numpy(_NUM_SAMPLE, -1.0, 16.0, 0, 'carla', 4, 'grid')
    lo, hi = grid[:, :3].min(0), grid[:, :3].max(0)
    frame = np.random.RandomState(22).rand(100000, 3).astype(np.float32) * (hi - lo) + lo
    rows['nn1_direct'] = nn1_direct_line(torch, t_knn, dev, grid, frame, 'carla_scale')
    del grid, frame

    # K8 / K9 / K10: the shared-gather kernels with the cv1 decoder's weights.
    ccfg = TrainConfig(**_CV1)
    cv1_encoder, cv1_decoder, _ = seeded_models(torch, ccfg, dev, 4)
    cv1_params = cv1_decoder.pt_blocks[0].layer2.kernel_params()
    check_shared_gather_kernels(torch, t_attn, dev, rng, cv1_params, E, rows)
    # K11 / K12 / K13: their backward kernels at one cv1 train frame.
    with torch.no_grad():
        check_shared_gather_backward_kernels(torch, t_attn, dev, rng, cv1_params, E, rows)
    del cv1_params
    # K14 / K15: the encoder's fused self-attention, forward and backward.
    check_self_attention_kernels(torch, dev, np.random.RandomState(21), encoder, rows)
    torch.cuda.empty_cache()

    # 4-13. The phases, in order (a --phases list runs the named ones and
    # the ones they need, _PHASE_NEEDS), each followed by the card's cache
    # emptied and its seconds.
    import shutil
    import tempfile
    path_counts = {}
    ctx = {}

    def ph_main_path():
        """4. The main path: encode + dense decode at gv1 width."""
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
        missing = [k for k in _INFER if counts.get(k, 0) <= 0]
        shared = [k for k in _SHARED if counts.get(k, 0) != 0]
        if missing or shared:
            raise AssertionError(f'kernels not launched on the main path: {missing}; '
                                 f'shared-gather kernels launched at M = 531: {shared}')
        path_counts['main_path'] = counts
        # The f32 scene that the 'fast' scene of main_path_fast is held against.
        ctx.setdefault('f32_scenes', {})['gv1'] = (dict(density=out[:, 0].clone(), scene_ms=(t2 - t0) * 1e3,
                                  decode_ms=(t2 - t1) * 1e3, pcl=pcl, queries=queries,
                                  cfg=cfg, models=(encoder, decoder), seg=False))
        del out

    def ph_main_path_cv1():
        """4b. cv1 at full width over the CARLA grid: the shared-gather route."""
        engine = InferenceEngine(dict(encoder=cv1_encoder, decoder=cv1_decoder, device=dev),
                                 ccfg.color_mode, True, ccfg.semantic_classes,
                                 track_mode='none', implicit_batch_size=_CHUNK)
        queries = blind_points_numpy(_NUM_SAMPLE, ccfg.min_z, ccfg.cr_cube_bounds, 0,
                                     'carla', ccfg.cube_mode, 'grid')
        r = np.random.RandomState(5)
        pcl = r.rand(14336, 8).astype(np.float32) * 2 - 1
        lo, hi = queries[:, :3].min(0), queries[:, :3].max(0)
        pcl[:, :3] = r.rand(14336, 3).astype(np.float32) * (hi - lo) + lo  # in the cuboid.
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
        path_counts['main_path_cv1'] = counts
        finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(abstract).all())
        # One chunk again on the CPU (plain versions, the same shared-gather
        # route) from the card's abstract cloud and global vector.
        cpu = InferenceEngine(dict(encoder=None, decoder=copy.deepcopy(cv1_decoder).cpu(),
                                   device=torch.device('cpu')),
                              ccfg.color_mode, True, ccfg.semantic_classes,
                              track_mode='none', implicit_batch_size=_CHECK_CHUNK)
        t3 = time.time()
        ref = cpu.decode_all(queries[:_CHECK_CHUNK], abstract.cpu(), fg.cpu())
        cpu_s = time.time() - t3
        got = out[:_CHECK_CHUNK].cpu().numpy()
        d_err = float(np.abs(got[:, 0] - ref[:, 0]).max())
        all_err = float(np.abs(got - ref).max())
        chunks = -(-queries.shape[0] // _CHUNK)
        expect = dict(gather=chunks, interp_g=chunks, attn_g=2 * chunks, attn=0, interp=0)
        counts_ok = all(counts.get(k, 0) == v for k, v in expect.items())
        emit(dict(phase='main_path_cv1', model='cv1', n_points=14336,
                  abstract_shape=list(abstract.shape), global_shape=list(fg.shape),
                  queries=int(queries.shape[0]), chunk=_CHUNK, chunks=chunks,
                  out_shape=list(out.shape), finite=finite, encode_ms=(t1 - t0) * 1e3,
                  decode_ms=(t2 - t1) * 1e3, scene_ms=(t2 - t0) * 1e3,
                  queries_per_s=queries.shape[0] / (t2 - t1),
                  solid_frac=float((out[:, 0] >= 0.5).float().mean()), launches=counts,
                  expected_launches=expect, cpu_check_queries=_CHECK_CHUNK,
                  cpu_check_s=cpu_s, density_max_abs_err_vs_cpu=d_err,
                  all_channels_max_abs_err_vs_cpu=all_err, gpu=smi))
        if not finite or list(abstract.shape) != [1, _CV1_M, 3 + 288] \
                or list(out.shape) != [queries.shape[0], 18]:
            raise AssertionError('cv1 output is not finite or has the wrong shape')
        if not counts_ok:
            raise AssertionError(f'cv1 launches {counts} differ from {expect}')
        if not d_err <= 1e-4:
            raise AssertionError(f'cv1 density differs from the CPU run by {d_err}')
        ctx.setdefault('f32_scenes', {})['cv1'] = dict(density=out[:, 0].clone(), scene_ms=(t2 - t0) * 1e3,
                                 decode_ms=(t2 - t1) * 1e3, pcl=pcl, queries=queries, cfg=ccfg,
                                 models=(cv1_encoder, cv1_decoder), seg=True)
        del out, engine, cpu

    def ph_main_path_fast():
        """4c. Both dense scenes again in precision='fast'."""
        path_counts['main_path_fast'] = {}
        for name, f32 in ctx.pop('f32_scenes').items():
            for k, v in fast_scene(torch, dev, smi, name, f32).items():
                path_counts['main_path_fast'][k] = path_counts['main_path_fast'].get(k, 0) + v
        torch.cuda.empty_cache()

    def ph_anchor():
        """5. Both anchors on the card against the CPU plain versions."""
        # The ground-truth labels through nn1_direct (the 'anchor' path's
        # launches).
        path_counts['anchor'] = {}
        for name in ('anchor', 'anchor_carla'):
            path = os.path.join(_HERE, 'tests', 'assets', name, 'checkpoint.pkl')
            res, fast_counts = {}, {}
            for run, device, precision in (('cuda', 'cuda', 'auto'), ('cpu', 'cpu', 'auto'),
                                           ('fast', 'cuda', 'fast')):
                L = load_models(path, device=device)
                c = L['train_config']
                seg = c.segmentation_lw > 0
                eng = InferenceEngine(L, c.color_mode, seg, c.semantic_classes,
                                      track_mode='all', implicit_batch_size=_CHUNK,
                                      precision=precision)
                r = np.random.RandomState(3)
                n = L['encoder_args']['n_input']
                cl = r.rand(n, 8).astype(np.float32) * 2 - 1
                cl[:, -1] = 0.0
                inst = (r.rand(n) > 0.5).astype(np.int64)
                sem = np.stack([inst, inst, np.full(n, 4)], -1)
                tgt = r.rand(2000, 11).astype(np.float32) * 2 - 1
                if device == 'cuda':
                    torch.cuda.synchronize()
                    _build.reset_launch_counts()
                res[run] = perform_inference(
                    cl, sem, tgt, eng, c.min_z, c.cr_cube_bounds, c.color_mode, 0,
                    num_sample=65536, point_sample_mode='grid', predict_segmentation=seg,
                    track_mode='all', semantic_classes=c.semantic_classes,
                    data_kind=L['data_kind'], cube_mode=c.cube_mode)
                if run == 'cuda':
                    torch.cuda.synchronize()
                    for k, v in _build.launch_counts().items():
                        path_counts['anchor'][k] = path_counts['anchor'].get(k, 0) + v
                elif run == 'fast':
                    torch.cuda.synchronize()
                    fast_counts = _build.launch_counts()
            g, cpu = res['cuda']['implicit_output'], res['cpu']['implicit_output']
            err = float(np.abs(g[:, 0] - cpu[:, 0]).max())
            far = np.abs(cpu[:, 0] - 0.5) > 1e-3
            split_ok = bool(np.array_equal((g[:, 0] >= 0.5)[far], (cpu[:, 0] >= 0.5)[far]))
            # Labels and 1-NN target rows, query by query, equal to the CPU's.
            gt_g, gt_c = gt_per_query(res['cuda']), gt_per_query(res['cpu'])
            gt_equal = bool(np.array_equal(gt_g, gt_c))
            # precision='fast' on the card against the f32 run: its flip share.
            fast = res['fast']['implicit_output']
            f_share, f_n, f_far32, f_far = flip_stats(torch.tensor(fast[:, 0]), torch.tensor(g[:, 0]))
            fast_bf16 = (fast_counts.get('attn_bf16', 0) + fast_counts.get('attn_g_bf16', 0) > 0
                         and all(fast_counts.get(k, 0) == 0 for k in _FAST_F32))
            ok = bool(np.isfinite(g).all()) and err <= 1e-4 and split_ok and gt_equal \
                and bool(np.isfinite(fast).all()) and fast.shape == g.shape and fast_bf16
            emit(dict(phase='anchor', name=name, queries=int(g.shape[0]),
                      reruns=res['cuda']['phase_s']['track_reruns'],
                      solid=int(len(res['cuda']['output_solid'])),
                      density_max_abs_err_vs_cpu=err, split_agrees=split_ok,
                      gt_labels_and_rows_equal_cpu=gt_equal,
                      gt_label_mismatches=int((gt_g[:, 0] != gt_c[:, 0]).sum()),
                      gt_solid_labels=int(gt_g[:, 0].sum()),
                      fast_density_flip_share=f_share, fast_density_flips=f_n,
                      fast_flip_max_abs_p_f32_minus_half=f_far32,
                      fast_flip_max_abs_p_fast_minus_half=f_far,
                      fast_density_max_abs_diff_vs_f32=float(np.abs(fast[:, 0] - g[:, 0]).max()),
                      fast_launches={k: fast_counts.get(k, 0) for k in _FAST + _FAST_F32},
                      ok=ok))
            if not ok:
                raise AssertionError(f'{name}: GPU inference disagrees with the CPU run, or the '
                                     f"'fast' run failed (bf16 launches {fast_bf16})")
            if name == 'anchor':
                nn1_direct_line(torch, t_knn, dev, res['cuda']['points_query'], tgt,
                                'anchor_grid_x_target')
        if path_counts['anchor'].get('nn1_direct', 0) <= 0:
            raise AssertionError('the anchors\' ground-truth labels did not launch nn1_direct')

    def train_data():
        """The gv1 recipe's synthetic train / val dataset (made once)."""
        if 'train_data' not in ctx:
            from occlusions4d_torch.data import synthetic
            ctx['train_tmp'] = tempfile.mkdtemp(prefix='o4d_train_data_')
            data = os.path.join(ctx['train_tmp'], 'gv1_data')
            synthetic.make_greater_dataset(data, **_TD_GV1_SCENE)
            ctx['train_data'] = data
        return ctx['train_data']

    def ph_train():
        """6. The gv1 train step."""
        from occlusions4d_torch.train import Trainer
        tcfg = TrainConfig(**_GV1_TRAIN)
        tr = Trainer(tcfg, 'greater', 'cuda')
        wrng = np.random.RandomState(2)
        tr.init_state(params=dict(encoder=random_jax_params(tr.encoder, wrng),
                                  decoder=random_jax_params(tr.decoder, wrng)),
                      seed=0, steps_per_epoch=100)
        batch = train_batch(torch, tcfg, dev)
        steps, counts, changed, peak_gb, split, warm_ms = run_train_phase(torch, tr, batch, 3)
        path_counts['train'] = counts
        # The sampler's pruned 1-NN (air rejections) at its gv1 shape.
        tgt0 = batch['pcl_target'][:, 0, :, :3].contiguous()
        cand = tgt0[:, :6996] + 0.3
        _build.reset_launch_counts()
        with torch.no_grad():
            tr.encoder(batch['pcl_input'], generator=tr.generator)
        enc_pruned = _build.launch_counts()['knn_pruned']
        calls = counts['knn_pruned'] // 3 - enc_pruned   # per step, less the encoder's.
        pruned_ms = cuda_ms(torch, lambda: t_knn.nn1_min_dist(cand, tgt0), 5)
        step_ms = float(np.mean([st['ms'] for st in steps]))
        ok = (all(np.isfinite(st['total_loss']) and st['grads_finite'] and st['params_finite']
                  for st in steps) and changed > 0.0
              and list(split) == ['encoder', 'sampler', 'decoder_forward', 'decoder_backward',
                                  'encoder_backward', 'optimizer'])
        emit(dict(phase='train', model='gv1', batch_size=tcfg.batch_size,
                  frames=tcfg.past_frames, queries_per_frame=7168 + 10752,
                  warmup_ms=warm_ms, step_ms=[st['ms'] for st in steps], mean_step_ms=step_ms,
                  steps=steps, launches=counts, params_changed_max_abs=changed,
                  split_ms=split, peak_mem_gib=peak_gb,
                  sampler_pruned_knn_ms_per_call=pruned_ms, sampler_pruned_knn_calls=calls,
                  sampler_pruned_knn_share=pruned_ms * calls / step_ms, ok=ok, gpu=smi))
        missing = [k for k in _TRAIN if counts.get(k, 0) <= 0]
        if missing or not ok:
            raise AssertionError(f'train phase failed: not launched {missing}, ok={ok}')
        # interp_bwd on the indices of one real train frame (sampled queries
        # against the seeded encoder's abstract cloud), for their key skew.
        with torch.no_grad():
            abstract, _ = tr.encoder(batch['pcl_input'], generator=tr.generator)
            frame = tr.pipeline.sample_frames(batch, tr.generator)[0]
            ki, kd = t_attn.knn_extract(frame['points_query'][..., :3], abstract[..., :3],
                                        tcfg.cross_attn_neighbors)
            gi = torch.randn((ki.shape[0], ki.shape[1], abstract.shape[2] - 3), device=dev)
            rows['interp_bwd']['real_frame'] = interp_bwd_line(
                torch, t_attn, dev, ki, kd, gi, abstract.shape[1], tcfg.num_cr_local_feats,
                'gv1_real_frame')
            del abstract, frame, ki, kd, gi
        ctx['train'] = (tr, batch, tcfg)

    def ph_sampler_moving():
        """7. The sampler's 'moving' branch at gv1 sizes."""
        tr, batch, tcfg = ctx.pop('train')
        from occlusions4d_torch.models.factory import build_sampler_args
        from occlusions4d_torch.sampler import GuidedPointSampler, SamplerConfig
        sampler = GuidedPointSampler(SamplerConfig(**dict(
            build_sampler_args(tcfg, 'greater'), point_sample_bias='moving')))
        tgt = batch['pcl_target'][:, 0]
        valid = batch['pcl_target_valid'][:, 0]
        other = tgt.clone()
        other[:, :2000, :3] += 3.0                   # a moved object.
        _build.reset_launch_counts()
        t0 = time.time()
        res = sampler.sample_frame(tr.generator, tgt, valid, other, valid, batch['valo_ids'],
                                   batch['num_valo_ids'], 0)
        torch.cuda.synchronize()
        s_ms = (time.time() - t0) * 1e3
        counts = _build.launch_counts()
        path_counts['sampler_moving'] = counts
        a, b3 = tgt[..., :3].contiguous(), other[..., :3].contiguous()
        ka, kb = t_knn.nn1_bidir_rank(a, t_knn.sq_norm(a), b3, t_knn.sq_norm(b3))
        pa, pb = t_knn.nn1_bidir_plain(a, t_knn.sq_norm(a), b3, t_knn.sq_norm(b3))
        torch.cuda.synchronize()
        exact = bool(torch.equal(ka, pa)) and bool(torch.equal(kb, pb))
        finite = all(bool(torch.isfinite(res[k]).all())
                     for k in ('solid_input', 'air_input', 'solid_target', 'air_target'))
        emit(dict(phase='sampler_moving', ms=s_ms, launches=counts, nn1_exact=exact,
                  finite=finite, solid_sbs=res['solid_sbs'].mean(0).tolist(),
                  air_sbs=res['air_sbs'].mean(0).tolist(), ok=bool(res['ok'].all()),
                  air_pool_counts=res['air_pool_counts'].tolist()))
        if counts['nn1_bidir'] <= 0 or not exact or not finite:
            raise AssertionError('sampler_moving failed: nn1_bidir launches '
                                 f'{counts["nn1_bidir"]}, exact {exact}, finite {finite}')

        del tr, batch, res

    def ph_train_cv1():
        """8. The cv1 train step: the shared-gather route's backward kernels."""
        rows['scatter']['real_frame'] = train_cv1(torch, dev, smi, path_counts)

    phases = dict(
        main_path=ph_main_path, main_path_cv1=ph_main_path_cv1,
        main_path_fast=ph_main_path_fast, anchor=ph_anchor,
        eval_driver=lambda: eval_driver(torch, dev, smi, path_counts),
        train_driver=lambda: train_driver(torch, dev, smi, path_counts),
        reference_pth=lambda: reference_pth(torch, dev, smi, path_counts, train_data()),
        train_batchnorm=lambda: train_batchnorm(torch, dev, smi, path_counts),
        train_loader_workers=lambda: train_loader_workers(torch, smi, train_data()),
        train_data_parallel=lambda: train_data_parallel(torch, dev, smi, path_counts,
                                                        train_data()),
        eval_query_parallel=lambda: eval_query_parallel(torch, dev, smi, path_counts),
        train=ph_train, sampler_moving=ph_sampler_moving, train_cv1=ph_train_cv1,
        train_bf16=lambda: train_bf16(torch, dev, smi, path_counts),
        train_sattn=lambda: train_fused_phase(torch, dev, smi, path_counts, 'train_sattn',
                                              _GV1_TRAIN, _SATTN_STEP, 8),
        train_57k=lambda: train_fused_phase(torch, dev, smi, path_counts, 'train_57k', _N57,
                                            _57K_STEP, 10),
        train_mixed=lambda: train_mixed(torch, dev, smi, path_counts),
        decoder_wide=lambda: decoder_wide(torch, t_attn, dev, smi),
        profile_trace=lambda: profile_trace(torch, dev, smi, path_counts, train_data()),
        train_module_decoder=lambda: train_module_decoder(torch, dev, smi, path_counts),
        check_numerics=lambda: check_numerics(torch, dev, smi, path_counts),
        store_activations=lambda: store_activations(torch, dev, smi, path_counts),
        encoder_up=lambda: encoder_up(torch, t_knn, t_fps, dev, smi, path_counts))
    assert tuple(phases) == PHASES
    run = phases_to_run(only)
    emit(dict(phase='phases', requested=list(only) if only else 'all', run=list(run)))
    try:
        for name in run:
            t0 = time.time()
            phases[name]()
            torch.cuda.empty_cache()
            emit(dict(phase='phase_seconds', name=name, seconds=time.time() - t0))
    finally:
        if 'train_tmp' in ctx:
            shutil.rmtree(ctx['train_tmp'], ignore_errors=True)

    # 14. Summary lines: every kernel's row (with a --phases list, the rows
    # the run phases launched), its launches on its path and on each phase
    # of _PHASE_COLUMNS.
    kernels = []
    for name, src in _SOURCE.items():
        path = _PATH[name]
        ran = [ph for ph in run if ph in path_counts]
        if only and not any(path_counts[ph].get(name, 0) for ph in ran):
            continue
        row = dict(name=name, route='cuda', source=f'occlusions4d_torch/csrc/{src}.cu',
                   replaces=_REPLACES[name], path=path)
        row['launches'] = int(path_counts[path].get(name, 0) if path in path_counts
                              else sum(path_counts[ph].get(name, 0) for ph in ran))
        for phase in _PHASE_COLUMNS:
            if phase in path_counts:
                row[phase] = int(path_counts[phase].get(name, 0))
        if name in _OFF_PATH:
            row['on_main_path'] = False
            row['note'] = _OFF_PATH[name]
        elif row['launches'] <= 0:
            raise AssertionError(f'{name} did not launch on its path {path}')
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
    if sys.argv[1:2] == ['--loader-workers']:
        sys.path.insert(0, _HERE)
        sys.exit(loader_workers_child(sys.argv[2]))
    if sys.argv[1:2] == ['--convergence']:
        sys.path.insert(0, _HERE)
        sys.exit(convergence_child(sys.argv[2]))
    try:
        only = parse_phases(sys.argv[1:])
    except ValueError as e:
        print(f'chip_smoke: {e}', file=sys.stderr)
        sys.exit(2)
    sys.exit(main(only))
