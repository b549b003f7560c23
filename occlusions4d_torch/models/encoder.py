'''
Point-transformer encoder (port of occlusions4d_tpu/models/encoder.py):
pre-MLP -> down_blocks x [PT block + DownTransition] -> center PT block ->
global embedding, with the multi-level abstract output of abstract_levels > 1,
or, with enable_decoder (and skip_connections), an up path: up_blocks x
[UpTransition from the matching down level's skip + PT block], then
post_mlp over the input's points (no shipped configuration enables it).

dtype (JAX's, bf16 under mixed_precision): the features in the dtype from
pre_mlp on (it reads the cloud cast to the dtype), the positions f32 through
FPS and every kNN; pcl_out carries the positions cast to the dtype, so the
decoder's kNN reads bf16-rounded positions in bf16.
'''

import torch
from torch import nn

from ..ops.fps import random_start_indices
from ..utils import profiling
from .layers import Dense, DownTransition, PointTransformerBlock, UpTransition

__all__ = ['PointEncoder']


class PointEncoder(nn.Module):
    '''Constructor arguments are the checkpoint's encoder_args, plus
    fused_attention ('auto'|'on'|'off'), the PT blocks' self-attention path
    (models/layers.py::VectorAttention.fused; 'on' = the fused self-attention
    kernels), and dtype (torch.float32 | torch.bfloat16, the modules'
    compute dtype). Like the JAX encoder's, they are runtime choices of how
    the same parameters are computed with, not part of encoder_args.'''

    def __init__(self, n_input=4096, n_output=1024, d_in=6, d_out=6, d_feat=32,
                 down_blocks=3, up_blocks=2, transition_factor=4,
                 pt_num_neighbors=16, pt_norm_type='none', down_neighbors=8,
                 abstract_levels=1, skip_connections=False, enable_decoder=False,
                 output_featurized=True, output_global_emb=True, global_dim=512,
                 fps_random_start=True, fused_attention='auto', dtype=torch.float32):
        super().__init__()
        if enable_decoder and not (output_featurized and skip_connections):
            raise ValueError('enable_decoder needs output_featurized and skip_connections')
        if abstract_levels > 1 and skip_connections:
            raise ValueError('abstract_levels > 1 excludes skip_connections')
        self.enable_decoder = enable_decoder
        self.up_blocks = up_blocks
        self.skip_connections = skip_connections
        self.d_feat = d_feat
        self.fps_random_start = fps_random_start
        self.down_blocks = down_blocks
        self.abstract_levels = abstract_levels
        self.output_featurized = output_featurized
        self.output_global_emb = output_global_emb
        self.dtype = dtype
        self.pre_mlp = nn.Sequential(Dense(d_in, d_feat, dtype=dtype), nn.ReLU(),
                                     Dense(d_feat, d_feat, dtype=dtype))
        blocks = []
        dim = d_feat
        for _ in range(down_blocks):
            blocks.append(PointTransformerBlock(dim, dim, dim, pt_num_neighbors,
                                                fused=fused_attention, dtype=dtype))
            blocks.append(DownTransition(dim, dim * 2, transition_factor,
                                         down_neighbors, pt_norm_type, dtype))
            dim *= 2
        blocks.append(PointTransformerBlock(dim, dim, dim, pt_num_neighbors,
                                            fused=fused_attention, dtype=dtype))
        if enable_decoder:
            for _ in range(up_blocks):
                blocks.append(UpTransition(dim, dim // 2, transition_factor, 3,
                                           pt_norm_type, dtype))
                blocks.append(PointTransformerBlock(dim // 2, dim // 2, dim // 2,
                                                    pt_num_neighbors, fused=fused_attention,
                                                    dtype=dtype))
                dim //= 2
            self.post_mlp = nn.Sequential(Dense(dim, dim, dtype=dtype), nn.ReLU(),
                                          Dense(dim, d_out - 3, dtype=dtype))
        self.blocks = nn.ModuleList(blocks)
        final_dim = d_feat * 2 ** down_blocks
        self._skip_at = {}  # width after a DownTransition -> skip index.
        skips = []
        for j in range(abstract_levels - 1):
            cur = final_dim // int(2 ** (abstract_levels - 1 - j))
            self._skip_at[cur] = j
            skips.append(Dense(cur, final_dim, dtype=dtype))
        self.abstract_skip_mlps = nn.ModuleList(skips)
        if output_global_emb:
            self.global_mlp = nn.Sequential(Dense(final_dim, global_dim, dtype=dtype),
                                            nn.ReLU(),
                                            Dense(global_dim, global_dim, dtype=dtype))

    def forward(self, pcl, generator=None, return_intermediate=False):
        '''
        :param pcl (B, N, d_in): (x, y, z, R, G, B, t, mark_track).
        :param generator: torch.Generator of the training-time random FPS
            starts (used in train mode when fps_random_start; start 0 else).
        :param return_intermediate: also return the positions of every layer.
        :return (pcl_out (B, M_total, 3 + E) or None, x_global (B, G) or None),
            both in the dtype; with return_intermediate a third item, the
            list of (B, *, 3) positions: the input's twice (before and after
            pre_mlp), then after every PT block and DownTransition (and, with
            enable_decoder, every up level, then the input's), as the JAX
            encoder's layer_coords. With enable_decoder pcl_out is (B, N,
            d_out): the input's positions and post_mlp's output.
        While spans record (utils/profiling.py) the forward is tiled in the
        caller's span by encoder.extract (each PT block's kNN graph; each
        DownTransition's FPS start, FPS, kNN and max-pool) and
        encoder.blocks (the pre-MLP, the PT blocks, the transitions' MLPs,
        the skip and global MLPs, the up path); counters encoder.points (the
        input's points over the batch) and encoder.fps_picks (the points FPS
        keeps, all levels, over the batch).
        '''
        random_start = self.training and self.fps_random_start and generator is not None
        dt = self.dtype
        pos = pcl[..., :3]
        coords = [pos, pos]
        profiling.count('encoder.points', pcl.shape[0] * pcl.shape[1])
        with _blocks():
            x = self.pre_mlp(pcl.to(dt))
        skips = []
        skip_data = []          # (features, positions) before each DownTransition.
        blocks = list(self.blocks)
        for i in range(self.down_blocks):
            trans = blocks[2 * i + 1]
            with _extract():
                nbr = blocks[2 * i].layer2.neighbours(pos)
            with _blocks():
                x, pos = blocks[2 * i](x, pos, nbr=nbr)
                y = trans.mlp(x)
            coords.append(pos)
            if self.skip_connections:
                skip_data.append((x, pos))
            with _extract():
                start = (random_start_indices(generator, x.shape[0], x.shape[1],
                                              device=x.device) if random_start else None)
                profiling.count('encoder.fps_picks', x.shape[0] * -(-x.shape[1] // trans.factor))
                x, pos = trans.pool(y, pos, start_idx=start)
            coords.append(pos)
            j = self._skip_at.get(x.shape[-1])
            if j is not None:
                with _blocks():
                    y = self.abstract_skip_mlps[j](x)
                    y = torch.cat([y[..., :-1], torch.full_like(y[..., -1:], j + 1.0)], -1)
                    skips.append(torch.cat([pos.to(dt), y], -1))
        center = 2 * self.down_blocks
        with _extract():
            nbr = blocks[center].layer2.neighbours(pos)
        with _blocks():
            x, pos = blocks[center](x, pos, nbr=nbr)
            coords.append(pos)
            extra = (coords,) if return_intermediate else ()
            x_global = None
            if self.output_global_emb:
                x_global = self.global_mlp(x.mean(dim=1))
            if self.enable_decoder:
                for i in range(self.up_blocks):
                    x2, p2 = skip_data.pop(-1)
                    x, pos = blocks[center + 1 + 2 * i](x, pos, x2, p2)
                    x, pos = blocks[center + 2 + 2 * i](x, pos)
                    coords.append(pos)
                coords.append(coords[0])
                return (torch.cat([coords[0].to(dt), self.post_mlp(x)], -1), x_global) + extra
            if not self.output_featurized:
                return (None, x_global) + extra
            pcl_out = torch.cat([pos.to(dt), x], -1)
            if self.abstract_levels > 1:
                # Last feature channel of every level holds the 1-based level index.
                pcl_out = torch.cat([pcl_out[..., :-1], torch.full_like(
                    pcl_out[..., -1:], float(self.abstract_levels))], -1)
                pcl_out = torch.cat(skips + [pcl_out], dim=1)
            return (pcl_out, x_global) + extra


def _extract():
    return profiling.span('encoder.extract', tile=True)


def _blocks():
    return profiling.span('encoder.blocks', tile=True)
