'''
Operations and bytes of the 4D field's networks, from a configuration's
sizes: the yardstick of the mfu and roofline metrics.

Counted: the multiply-adds of every product the networks' equations hold,
two operations each, as the model states them (the cross attention's key
and value projections once per key and frame, whichever route the program
takes). Not counted: kNN, FPS, the sampler's comparisons, softmax and other
elementwise work. A backward is two forward products per product, with no
recompute (a training step is three forward passes).

The attention's bytes read each input once (queries' positions and
projections, the neighbour indices, the key rows, the weights) and write
each output once; the backward also reads the output's cotangent and writes
the cotangents of the queries, keys and weights. An f32 word is 4 bytes.
'''

import math

POS_HIDDEN = 32        # the vector attention's position MLP width.


def widths(cfg):
    d_local = cfg['pt_feat_dim'] * 2 ** cfg['up_down_blocks']
    d = cfg['global_size'] + d_local
    color = {'rgb': 3, 'rgb_nosigmoid': 3, 'hsv': 14, 'bins': 9}[cfg['color_mode']]
    d_out = 1 + color + 1 + (cfg['semantic_classes'] if cfg['segmentation_lw'] > 0 else 0)
    return dict(D=d, E=d_local, H=2 * d, P=POS_HIDDEN, K=cfg['cross_attn_neighbors'],
                d_out=d_out, enc=4 * 17)


def pyramid(cfg):
    '''Points per encoder level, the input's first.'''
    n = [cfg['n_points']]
    for _ in range(cfg['up_down_blocks']):
        n.append(-(-n[-1] // cfg['transition_factor']))
    return n


def abstract_points(cfg):
    n = pyramid(cfg)
    return sum(n[-cfg['abstract_levels']:])


def attention_query_macs(w):
    '''One cross-attention layer, one query, the neighbour rows' products:
    theta (3 -> P -> D) and gamma (D -> H -> D) for each of K neighbours.'''
    return w['K'] * (3 * w['P'] + w['P'] * w['D'] + 2 * w['D'] * w['H'])


def decoder_query_macs(cfg):
    '''Products of one query through the decoder, the attention's key
    projections left out (per key, attention_key_macs).'''
    w = widths(cfg)
    D, L, nb = w['D'], cfg['cross_attn_layers'], cfg['implicit_mlp_blocks']
    backbone = w['enc'] * D + nb * 3 * D * D + D * w['d_out']
    interp = cfg['num_cr_local_feats'] * w['E']
    cross = L * (3 * D * D + attention_query_macs(w))
    return backbone + interp + cross


def attention_key_macs(cfg):
    '''Key and value projections of every abstract point, all layers.'''
    w = widths(cfg)
    return cfg['cross_attn_layers'] * abstract_points(cfg) * 2 * w['E'] * w['D']


def encoder_macs(cfg):
    '''Products of one example through the encoder.'''
    n = pyramid(cfg)
    F, K = cfg['pt_feat_dim'], cfg['pt_num_neighbors']
    macs = n[0] * (8 * F + F * F)
    dim = F
    for level in range(cfg['up_down_blocks'] + 1):
        pts = n[level]
        macs += pts * (5 * dim * dim + K * (3 * POS_HIDDEN + POS_HIDDEN * dim
                                            + 4 * dim * dim))
        if level < cfg['up_down_blocks']:
            macs += pts * dim * 2 * dim      # the DownTransition's MLP.
            dim *= 2
    final = F * 2 ** cfg['up_down_blocks']
    for j in range(cfg['abstract_levels'] - 1):
        cur = final // 2 ** (cfg['abstract_levels'] - 1 - j)
        level = cfg['up_down_blocks'] - int(math.log2(final // cur))
        macs += n[level] * cur * final
    g = cfg['global_size']
    return macs + final * g + g * g


def train_queries(cfg):
    return cfg['num_cr_solid'] + int(cfg['num_cr_solid'] * cfg['air_sampling_ratio'])


def train_step_flops(cfg):
    '''Model operations of one train step: 3 x the forward of the batch.'''
    B, T = cfg['batch_size'], cfg['past_frames'] + cfg['future_frames']
    fwd = B * (encoder_macs(cfg)
               + T * (train_queries(cfg) * decoder_query_macs(cfg) + attention_key_macs(cfg)))
    return 3 * 2 * fwd


def scene_flops(cfg, n_queries):
    '''Model operations of one dense scene: encode one cloud, decode every
    query.'''
    return 2 * (encoder_macs(cfg) + n_queries * decoder_query_macs(cfg)
                + attention_key_macs(cfg))


def attention_forward(cfg, n_queries):
    '''(operations, bytes) of one cross-attention layer's kernel over
    n_queries queries of one abstract cloud.'''
    w = widths(cfg)
    M = abstract_points(cfg)
    flops = 2 * (n_queries * attention_query_macs(w) + M * 2 * w['E'] * w['D'])
    n_w = (3 * w['P'] + w['P'] * w['D'] + 2 * w['D'] * w['H'] + 2 * w['E'] * w['D']
           + w['P'] + 2 * w['D'] + w['H'])
    nbytes = 4 * (n_queries * (3 + w['D'] + w['K'] + w['D']) + M * (3 + w['E']) + n_w)
    return flops, nbytes


def attention_backward(cfg, n_queries):
    '''(operations, bytes) of the same layer's backward: twice the forward's
    products; reads the forward's inputs and the output cotangent, writes
    the cotangents of the queries, the keys and the weights.'''
    flops, nbytes = attention_forward(cfg, n_queries)
    w = widths(cfg)
    M = abstract_points(cfg)
    n_w = (3 * w['P'] + w['P'] * w['D'] + 2 * w['D'] * w['H'] + 2 * w['E'] * w['D']
           + w['P'] + 2 * w['D'] + w['H'])
    return 2 * flops, nbytes + 4 * (n_queries * w['D'] + M * w['E'] + n_w)


def train_attention_backward(cfg):
    '''(operations, bytes) of every cross-attention backward of one step.'''
    B, T = cfg['batch_size'], cfg['past_frames'] + cfg['future_frames']
    f, b = attention_backward(cfg, train_queries(cfg))
    n = B * T * cfg['cross_attn_layers']
    return n * f, n * b


def scene_attention_forward(cfg, n_queries):
    '''(operations, bytes) of every cross-attention forward of one scene.'''
    f, b = attention_forward(cfg, n_queries)
    return cfg['cross_attn_layers'] * f, cfg['cross_attn_layers'] * b
