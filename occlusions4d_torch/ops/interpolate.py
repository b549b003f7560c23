'''
kNN feature interpolation by inverse-distance weighting (port of
occlusions4d_tpu/ops/interpolate.py). The module path of the decoder uses it;
the fused decoder path uses ops.attention.fused_knn_interp (a kernel).
'''

import torch

from .knn import gather_neighbors, knn

__all__ = ['inverse_distance_weights', 'knn_interpolate']


def inverse_distance_weights(dists, eps):
    '''(..., K) Euclidean distances -> L1-normalized weights 1 / (d + eps).'''
    w = 1.0 / (dists + eps)
    return w / torch.sum(w, dim=-1, keepdim=True)


def knn_interpolate(features, points, points_query, k, *, eps=1e-7, key_mask=None):
    '''features (B, N, D), points (B, N, 3), points_query (B, M, 3) -> (B, M, D).'''
    dists, idx = knn(points_query, points, k, key_mask=key_mask)
    w = inverse_distance_weights(dists, eps)
    nbr = gather_neighbors(features, idx)
    return torch.einsum('bmk,bmkd->bmd', w, nbr)
