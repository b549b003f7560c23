'''
portbench: the benchmark of occlusions4d_torch, the PyTorch/CUDA port, on an
NVIDIA card.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Every cell of BENCHMARK.json names a configuration (configs/<name>.json), a
traffic mix (mixes/<name>.json, run by the loop module it names under drivers/)
and the per-layer metrics it reports (metrics/<name>.py). README.md says how
to add each. The benchmark imports the port and never the JAX package.
'''
