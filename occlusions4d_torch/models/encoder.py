'''
Point-transformer encoder (port of occlusions4d_tpu/models/encoder.py):
pre-MLP -> down_blocks x [PT block + DownTransition] -> center PT block ->
global embedding, with the multi-level abstract output of abstract_levels > 1.
The optional UpTransition decoder (enable_decoder) is dead in every shipped
configuration and is not ported.

dtype (JAX's, bf16 under mixed_precision): the features in the dtype from
pre_mlp on (it reads the cloud cast to the dtype), the positions f32 through
FPS and every kNN; pcl_out carries the positions cast to the dtype, so the
decoder's kNN reads bf16-rounded positions in bf16.
'''

import torch
from torch import nn

from ..ops.fps import random_start_indices
from .layers import Dense, DownTransition, PointTransformerBlock

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
        if enable_decoder:
            raise NotImplementedError('enable_decoder (UpTransition path) is not ported')
        if abstract_levels > 1 and skip_connections:
            raise ValueError('abstract_levels > 1 excludes skip_connections')
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
            self.global_mlp = nn.Sequential(Dense(dim, global_dim, dtype=dtype), nn.ReLU(),
                                            Dense(global_dim, global_dim, dtype=dtype))

    def forward(self, pcl, generator=None):
        '''
        :param pcl (B, N, d_in): (x, y, z, R, G, B, t, mark_track).
        :param generator: torch.Generator of the training-time random FPS
            starts (used in train mode when fps_random_start; start 0 else).
        :return (pcl_out (B, M_total, 3 + E) or None, x_global (B, G) or None),
            both in the dtype.
        '''
        random_start = self.training and self.fps_random_start and generator is not None
        dt = self.dtype
        pos = pcl[..., :3]
        x = self.pre_mlp(pcl.to(dt))
        skips = []
        blocks = list(self.blocks)
        for i in range(self.down_blocks):
            x, pos = blocks[2 * i](x, pos)
            start = (random_start_indices(generator, x.shape[0], x.shape[1],
                                          device=x.device) if random_start else None)
            x, pos = blocks[2 * i + 1](x, pos, start_idx=start)
            j = self._skip_at.get(x.shape[-1])
            if j is not None:
                y = self.abstract_skip_mlps[j](x)
                y = torch.cat([y[..., :-1], torch.full_like(y[..., -1:], j + 1.0)], -1)
                skips.append(torch.cat([pos.to(dt), y], -1))
        x, pos = blocks[-1](x, pos)

        x_global = None
        if self.output_global_emb:
            x_global = self.global_mlp(x.mean(dim=1))
        if not self.output_featurized:
            return None, x_global
        pcl_out = torch.cat([pos.to(dt), x], -1)
        if self.abstract_levels > 1:
            # Last feature channel of every level holds the 1-based level index.
            pcl_out = torch.cat([pcl_out[..., :-1], torch.full_like(
                pcl_out[..., -1:], float(self.abstract_levels))], -1)
            pcl_out = torch.cat(skips + [pcl_out], dim=1)
        return pcl_out, x_global
