'''
Implicit 4D neural-field decoder (port of occlusions4d_tpu/models/implicit.py):
positional encoding, the ResnetFC backbone, and LocalImplicitField (the module
path: kNN interpolation of the abstract features plus interleaved cross-
attention blocks). models/fused.py re-expresses the same forward with the
decoder kernels; the engine uses that path.

LocalImplicitField subclasses ResnetFC so the backbone's layers sit at the top
level (lin_in, blocks.i, lin_z.i, lin_out), the reference's key layout.

dtype (JAX's, bf16 under mixed_precision; models/layers.py says what a bf16
module rounds): the module path computes in it, the points and the
features cast to it on entry, the interpolation weights from the distances
cast to it. models/fused.py reads the same weights in f32 whatever the
dtype, as the JAX fused_field_apply does.
'''

import math

import torch
from torch import nn

from ..ops import gather_neighbors, inverse_distance_weights, knn
from .layers import Dense, PointTransformerBlock

__all__ = ['BASE_FREQUENCY', 'positional_encode', 'activation', 'ResnetBlockFC',
           'ResnetFC', 'LocalImplicitField']

BASE_FREQUENCY = 0.1


def dtype_scalar(x, dtype):
    '''The Python scalar x as JAX uses it against an array of dtype: rounded
    to that dtype (a weak-typed scalar takes the array's type; PyTorch would
    compute a bf16 tensor's product with x in f32).'''
    return x if dtype == torch.float32 else float(torch.tensor(x, dtype=dtype))


def positional_encode(points, base_frequency, num_powers):
    '''cat([p, sin(p w_0), cos(p w_0), ...]) with w_f = base 2^f 2 pi, in
    the points' dtype.'''
    terms = [points]
    for p in range(num_powers):
        omega = dtype_scalar(base_frequency * (2.0 ** p) * 2.0 * math.pi, points.dtype)
        terms.append(torch.sin(points * omega))
        terms.append(torch.cos(points * omega))
    return torch.cat(terms, dim=-1)


def activation(name):
    if name == 'relu':
        return torch.relu
    if name == 'swish':
        return nn.functional.silu
    raise ValueError(f'Unknown activation: {name}')


class ResnetBlockFC(nn.Module):
    '''act -> fc_0 -> act -> fc_1, residual (linear shortcut when widths differ).'''

    def __init__(self, d_in=64, d_hidden=256, d_out=64, activation_name='relu',
                 dtype=torch.float32):
        super().__init__()
        self.act = activation(activation_name)
        self.fc_0 = Dense(d_in, d_hidden, dtype=dtype)
        self.fc_1 = Dense(d_hidden, d_out, dtype=dtype)
        self.shortcut = (None if d_in == d_out
                         else Dense(d_in, d_out, bias=False, dtype=dtype))

    def forward(self, x):
        net = self.fc_0(self.act(x))
        dx = self.fc_1(self.act(net))
        xs = x if self.shortcut is None else self.shortcut(x)
        return xs + dx


class ResnetFC(nn.Module):
    '''MLP backbone with per-block latent injection.'''

    def __init__(self, d_in=4, d_hidden=256, d_out=64, d_latent=256, n_blocks=5,
                 pos_encoding_freqs=0, activation='relu', dtype=torch.float32):
        super().__init__()
        self.d_in = d_in
        self.d_latent = d_latent
        self.n_blocks = n_blocks
        self.pos_encoding_freqs = pos_encoding_freqs
        self.activation = activation
        self.dtype = dtype
        enc_width = d_in * (2 * pos_encoding_freqs + 1)
        if d_in > 0:
            self.lin_in = Dense(enc_width, d_hidden, dtype=dtype)
        self.lin_out = Dense(d_hidden, d_out, dtype=dtype)
        self.blocks = nn.ModuleList([ResnetBlockFC(d_hidden, d_hidden, d_hidden,
                                                   activation, dtype)
                                     for _ in range(n_blocks)])
        if d_latent > 0:
            self.lin_z = nn.ModuleList([Dense(d_latent, d_hidden, dtype=dtype)
                                        for _ in range(n_blocks)])

    def encode_points(self, points):
        points = points.to(self.dtype)
        if self.pos_encoding_freqs > 0:
            points = positional_encode(points, BASE_FREQUENCY, self.pos_encoding_freqs)
        return self.lin_in(points)

    def forward(self, points, features):
        '''points (B, N, d_in); features (B, D) or (B, N, D).
        :return (output (B, N, d_out), penult (B, N, d_hidden)).'''
        act = activation(self.activation)
        x = self.encode_points(points)
        features = features.to(self.dtype)
        for i in range(self.n_blocks):
            if self.d_latent > 0:
                z = self.lin_z[i](features)
                x = x + (z[:, None, :] if z.dim() == 2 else z)
            x = self.blocks[i](x)
        return self.lin_out(act(x)), x


class LocalImplicitField(ResnetFC):
    '''The 4D field with local conditioning and cross attention.'''

    def __init__(self, d_in=4, d_hidden=256, d_out=64, d_latent=256, n_blocks=5,
                 pos_encoding_freqs=0, activation='relu', num_local_features=0,
                 local_mode='attention', d_latent_local=64, cross_attn_neighbors=12,
                 cross_attn_layers=1, cr_attn_type='cccccccccc', dtype=torch.float32):
        super().__init__(d_in, d_hidden, d_out, d_latent, n_blocks,
                         pos_encoding_freqs, activation, dtype)
        self.num_local_features = num_local_features
        self.local_mode = local_mode
        self.d_latent_local = d_latent_local
        self.cross_attn_neighbors = cross_attn_neighbors
        self.cross_attn_layers = cross_attn_layers
        self.cr_attn_type = cr_attn_type
        if local_mode == 'attention':
            blocks = []
            for pt_idx in range(cross_attn_layers):
                kind = cr_attn_type[pt_idx]
                if kind == 's':
                    raise NotImplementedError('self-attention CR layers are obsolete')
                if kind != 'c':
                    raise ValueError(kind)
                blocks.append(PointTransformerBlock(
                    d_hidden, d_latent, d_latent, cross_attn_neighbors,
                    d_hidden_abstract=d_latent_local, dtype=dtype))
            self.pt_blocks = nn.ModuleList(blocks)

    @property
    def use_pt_inds(self):
        '''Backbone block index -> cross-attention layer index.'''
        return {int((i + 1) * self.n_blocks / (self.cross_attn_layers + 1)): i
                for i in range(self.cross_attn_layers)}

    def forward(self, points_query, pcl_abstract, features_global, abstract_mask=None):
        '''
        :param points_query (B, N, 4) (x, y, z, t); pcl_abstract (B, M, 3 + E);
            features_global (B, D); abstract_mask (B, M) bool or None.
        :return (output (B, N, d_out), penult (B, N, d_hidden)).
        '''
        if self.num_local_features <= 0:
            return super().forward(points_query, features_global)
        if self.local_mode not in ('feature', 'attention'):
            raise ValueError(self.local_mode)
        points_abstract = pcl_abstract[..., :3]
        features_abstract = pcl_abstract[..., 3:]
        B, N, _ = points_query.shape
        q_xyz = points_query[..., :3]
        dt = self.dtype
        # The kNN graph and its distances carry no gradient (JAX's
        # stop_gradient of both point sets).
        dists, idx = knn(q_xyz.detach(), points_abstract.detach(),
                         self.num_local_features, key_mask=abstract_mask)
        w = inverse_distance_weights(dists.to(dt), dtype_scalar(1e-4, dt))
        sel = gather_neighbors(features_abstract, idx)
        features_local = torch.einsum('bnk,bnke->bne', w, sel.to(dt))
        fg = features_global[:, None, :].to(dt).expand(B, N, features_global.shape[-1])
        features_query = torch.cat([fg, features_local], dim=-1)
        if self.local_mode == 'feature':
            return super().forward(points_query, features_query)

        act = activation(self.activation)
        x = self.encode_points(points_query)
        use_pt = self.use_pt_inds
        for i in range(self.n_blocks):
            x = x + self.lin_z[i](features_query)
            x = self.blocks[i](x)
            if i in use_pt:
                x, _ = self.pt_blocks[use_pt[i]](x, q_xyz, x2=features_abstract.to(dt),
                                                 p2=points_abstract,
                                                 key_mask=abstract_mask)
        return self.lin_out(act(x)), x
