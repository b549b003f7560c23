import os
import sys
import time
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Tiny widths of the two configurations: the loop modules and the reference run
# the port's plain versions on the CPU at these sizes.
TINY = dict(n_points=512, pt_feat_dim=8, up_down_blocks=2, pt_num_neighbors=8,
            down_neighbors=4, global_size=16, num_cr_local_feats=4, cross_attn_neighbors=6,
            implicit_mlp_blocks=3, num_cr_solid=96, batch_size=2, past_frames=2)
# CARLA's output cuboid holds a fifth of the target points: enough for the
# sampler's 256-point floor at this many.
TINY_POINTS = dict(gv1=512, cv1=2048)
TINY_SCENE = dict(num_sample=4096, implicit_batch_size=1024)


def tiny_context(cell_name, trace=0, seed=2 ** 31 + 11, seconds=0.5, device='cpu'):
    '''A run context of a BENCHMARK.json cell at tiny widths on the CPU.'''
    from portbench import registry
    from portbench.run import context
    bench = registry.benchmark()
    cell = registry.cell(bench, cell_name)
    ctx = context(bench, cell, seed, seconds, trace, device, time.time())
    ctx.config = dict(ctx.config, **dict(TINY, n_points=TINY_POINTS[cell["config"]]))
    if ctx.mix['driver'] == 'scene':
        ctx.mix = dict(ctx.mix, **TINY_SCENE)
    return bench, ctx


@pytest.fixture
def tiny():
    return tiny_context


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return types.SimpleNamespace(device='cuda')
