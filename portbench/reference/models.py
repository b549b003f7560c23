'''
Plain f32 networks of the reference: the point-transformer encoder and the
implicit decoder with its kNN interpolation and cross-attention blocks,
computed as their equations read (the decoder's module path: every
neighbour row gathered, the vector attention's MLPs as dense products, a
softmax over the neighbours).

A frozen copy of the f32 module code of occlusions4d_torch/models
(layers.py, encoder.py, implicit.py, factory.py) without the bf16, batch-norm
and fused paths, with the same parameter names and shapes, so that one set
of weights made from a seed loads into both. The decoder here never runs the
fused kernels' formulation (models/fused.py): it is the independent one.
'''

import math

import torch
from torch import nn
from torch.nn import functional as F

from .ops import fps, gather_neighbors, inverse_distance_weights, knn, random_start_indices

BASE_FREQUENCY = 0.1
_COLOR_Q = {'rgb': 3, 'rgb_nosigmoid': 3, 'hsv': 14, 'bins': 9}


def decoder_out_channels(cfg):
    d_out = 1 + _COLOR_Q[cfg['color_mode']] + 1
    if cfg['segmentation_lw'] > 0.0:
        d_out += cfg['semantic_classes']
    return d_out


def track_idx(color_mode):
    return 1 + _COLOR_Q[color_mode]


class NormLayer(nn.Module):
    '''none or layer (eps 1e-5).'''

    def __init__(self, norm_type, dim):
        super().__init__()
        if norm_type not in ('none', 'layer'):
            raise ValueError(f'the reference has no {norm_type!r} norm')
        self.norm_type = norm_type
        self.dim = dim
        if norm_type != 'none':
            self.weight = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        if self.norm_type == 'none':
            return x
        return F.layer_norm(x, (self.dim,), self.weight, self.bias, eps=1e-5)


def _mlp(d_in, d_hidden, d_out):
    return nn.Sequential(nn.Linear(d_in, d_hidden), nn.ReLU(), nn.Linear(d_hidden, d_out))


class VectorAttention(nn.Module):
    '''attn = softmax_K(gamma(q - k + theta(dp)) / sqrt(dim));
    out = sum_K attn * (v + theta).'''

    def __init__(self, dim, dim2=None, num_neighbors=16):
        super().__init__()
        self.dim = dim
        self.num_neighbors = num_neighbors
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim2 or dim, dim, bias=False)
        self.to_v = nn.Linear(dim2 or dim, dim, bias=False)
        self.pos_mlp = _mlp(3, 32, dim)
        self.attn_mlp = _mlp(dim, dim * 2, dim)

    def forward(self, x, pos, x2=None, pos2=None):
        pos = pos.detach()
        if x2 is None:
            x2, pos2 = x, pos
        pos2 = pos2.detach()
        _, idx = knn(pos, pos2, self.num_neighbors)
        knn_xyz = gather_neighbors(pos2[..., :3], idx)
        q = self.to_q(x)
        k = gather_neighbors(self.to_k(x2), idx)
        v = gather_neighbors(self.to_v(x2), idx)
        pe = self.pos_mlp(pos[..., None, :3] - knn_xyz)
        a = self.attn_mlp(q[..., None, :] - k + pe)
        attn = torch.softmax(a / math.sqrt(self.dim), dim=-2)
        return torch.einsum('bnkd,bnkd->bnd', attn, v + pe)


class PointTransformerBlock(nn.Module):
    '''Linear -> vector attention -> linear, with residual.'''

    def __init__(self, d_in, d_hidden, d_out, num_neighbors=16, d_hidden_abstract=None):
        super().__init__()
        self.layer1 = nn.Linear(d_in, d_hidden)
        self.layer2 = VectorAttention(d_hidden, dim2=d_hidden_abstract,
                                      num_neighbors=num_neighbors)
        self.layer3 = nn.Linear(d_hidden, d_out)

    def forward(self, x, p, x2=None, p2=None):
        return x + self.layer3(self.layer2(self.layer1(x), p, x2=x2, pos2=p2)), p


class DownTransition(nn.Module):
    '''FPS by 1/factor, per-point MLP, max-pool over the knn_k nearest input
    points of each kept point.'''

    def __init__(self, d_in, d_out, factor, knn_k, norm_type):
        super().__init__()
        self.factor = factor
        self.knn_k = knn_k
        self.mlp = nn.Sequential(nn.Linear(d_in, d_out), NormLayer(norm_type, d_out),
                                 nn.ReLU())

    def forward(self, x, p, start_idx=None):
        B, N, _ = x.shape
        n_new = -(-N // self.factor)
        sub_idx = fps(p, n_new, start_idx)
        p_sub = torch.gather(p, 1, sub_idx[..., None].expand(B, n_new, p.shape[-1]))
        _, nbr = knn(p_sub, p, self.knn_k)
        return gather_neighbors(self.mlp(x), nbr).amax(dim=-2), p_sub


class PointEncoder(nn.Module):
    '''pre-MLP -> down_blocks x [PT block + DownTransition] -> centre PT
    block -> global embedding; abstract_levels > 1 prepends the earlier
    levels' clouds (a skip MLP each) to the abstract output.'''

    def __init__(self, cfg):
        super().__init__()
        d_feat, down = cfg['pt_feat_dim'], cfg['up_down_blocks']
        self.down_blocks = down
        self.abstract_levels = cfg['abstract_levels']
        self.pre_mlp = nn.Sequential(nn.Linear(8, d_feat), nn.ReLU(), nn.Linear(d_feat, d_feat))
        blocks = []
        dim = d_feat
        for _ in range(down):
            blocks.append(PointTransformerBlock(dim, dim, dim, cfg['pt_num_neighbors']))
            blocks.append(DownTransition(dim, dim * 2, cfg['transition_factor'],
                                         cfg['down_neighbors'], cfg['pt_norm_type']))
            dim *= 2
        blocks.append(PointTransformerBlock(dim, dim, dim, cfg['pt_num_neighbors']))
        self.blocks = nn.ModuleList(blocks)
        final_dim = d_feat * 2 ** down
        self._skip_at = {}
        skips = []
        for j in range(self.abstract_levels - 1):
            cur = final_dim // int(2 ** (self.abstract_levels - 1 - j))
            self._skip_at[cur] = j
            skips.append(nn.Linear(cur, final_dim))
        self.abstract_skip_mlps = nn.ModuleList(skips)
        g = cfg['global_size']
        self.global_mlp = nn.Sequential(nn.Linear(final_dim, g), nn.ReLU(), nn.Linear(g, g))

    def forward(self, pcl, generator=None):
        '''pcl (B, N, 8) -> (abstract (B, M, 3 + E), global (B, G)); with a
        generator the FPS starts are drawn from it (training).'''
        pos = pcl[..., :3]
        x = self.pre_mlp(pcl)
        skips = []
        blocks = list(self.blocks)
        for i in range(self.down_blocks):
            x, pos = blocks[2 * i](x, pos)
            start = (random_start_indices(generator, x.shape[0], x.shape[1])
                     if generator is not None else None)
            x, pos = blocks[2 * i + 1](x, pos, start_idx=start)
            j = self._skip_at.get(x.shape[-1])
            if j is not None:
                y = self.abstract_skip_mlps[j](x)
                y = torch.cat([y[..., :-1], torch.full_like(y[..., -1:], j + 1.0)], -1)
                skips.append(torch.cat([pos, y], -1))
        x, pos = blocks[2 * self.down_blocks](x, pos)
        x_global = self.global_mlp(x.mean(dim=1))
        out = torch.cat([pos, x], -1)
        if self.abstract_levels > 1:
            out = torch.cat([out[..., :-1], torch.full_like(
                out[..., -1:], float(self.abstract_levels))], -1)
            out = torch.cat(skips + [out], dim=1)
        return out, x_global


def positional_encode(points, num_powers):
    terms = [points]
    for p in range(num_powers):
        omega = BASE_FREQUENCY * (2.0 ** p) * 2.0 * math.pi
        terms.append(torch.sin(points * omega))
        terms.append(torch.cos(points * omega))
    return torch.cat(terms, dim=-1)


class ResnetBlockFC(nn.Module):
    '''relu -> fc_0 -> relu -> fc_1, residual.'''

    def __init__(self, d):
        super().__init__()
        self.fc_0 = nn.Linear(d, d)
        self.fc_1 = nn.Linear(d, d)

    def forward(self, x):
        return x + self.fc_1(torch.relu(self.fc_0(torch.relu(x))))


class LocalImplicitField(nn.Module):
    '''The 4D field: positional encoding, a ResNet backbone with the global
    and interpolated local features injected into every block, and
    cross-attention blocks into the abstract cloud interleaved.'''

    def __init__(self, cfg):
        super().__init__()
        if cfg['local_implicit_mode'] != 'attention' or cfg['activation'] != 'relu' \
                or not cfg['positional_encoding']:
            raise ValueError('the reference decoder is the attention field with relu '
                             'and the positional encoding')
        d_local = cfg['pt_feat_dim'] * 2 ** cfg['up_down_blocks']
        d = cfg['global_size'] + d_local
        self.n_blocks = cfg['implicit_mlp_blocks']
        self.num_local_features = cfg['num_cr_local_feats']
        self.cross_attn_layers = cfg['cross_attn_layers']
        self.lin_in = nn.Linear(4 * 17, d)
        self.lin_out = nn.Linear(d, decoder_out_channels(cfg))
        self.blocks = nn.ModuleList([ResnetBlockFC(d) for _ in range(self.n_blocks)])
        self.lin_z = nn.ModuleList([nn.Linear(d, d) for _ in range(self.n_blocks)])
        self.pt_blocks = nn.ModuleList([
            PointTransformerBlock(d, d, d, cfg['cross_attn_neighbors'],
                                  d_hidden_abstract=d_local)
            for _ in range(self.cross_attn_layers)])

    def forward(self, points_query, pcl_abstract, features_global):
        '''points_query (B, N, 4), pcl_abstract (B, M, 3 + E), features_global
        (B, G) -> raw outputs (B, N, d_out).'''
        points_abstract = pcl_abstract[..., :3]
        features_abstract = pcl_abstract[..., 3:]
        B, N, _ = points_query.shape
        q_xyz = points_query[..., :3]
        dists, idx = knn(q_xyz.detach(), points_abstract.detach(), self.num_local_features)
        w = inverse_distance_weights(dists, 1e-4)
        sel = gather_neighbors(features_abstract, idx)
        features_local = torch.einsum('bnk,bnke->bne', w, sel)
        fg = features_global[:, None, :].expand(B, N, features_global.shape[-1])
        features_query = torch.cat([fg, features_local], dim=-1)
        x = self.lin_in(positional_encode(points_query, 8))
        use_pt = {int((i + 1) * self.n_blocks / (self.cross_attn_layers + 1)): i
                  for i in range(self.cross_attn_layers)}
        for i in range(self.n_blocks):
            x = x + self.lin_z[i](features_query)
            x = self.blocks[i](x)
            if i in use_pt:
                x, _ = self.pt_blocks[use_pt[i]](x, q_xyz, x2=features_abstract,
                                                 p2=points_abstract)
        return self.lin_out(torch.relu(x))


def build_models(cfg):
    '''(encoder, decoder) of a configuration dict (the TrainConfig fields).'''
    return PointEncoder(cfg), LocalImplicitField(cfg)
