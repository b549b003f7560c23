'''The operation and byte counts against figures worked out by hand.'''

from portbench import registry
from portbench.work import _field


def test_gv1_attention_chunk_by_hand():
    '''One cross-attention layer over a 32768-query gv1 chunk (D 416, E 288,
    K 14, H 832, P 32, M 531).'''
    cfg = registry.config('gv1')
    flops, nbytes = _field.attention_forward(cfg, 32768)
    per_neighbour = (3 * 32 + 32 * 416) + (416 * 832 + 832 * 416)     # theta, gamma.
    assert per_neighbour == 705632
    query_macs = 14 * 705632                                            # 9,878,848.
    key_macs = 531 * 2 * 288 * 416                                      # 127,236,096.
    assert flops == 2 * (32768 * query_macs + key_macs) == 647_674_654_720
    weights = 96 + 13312 + 692224 + 239616 + 32 + 832 + 832             # 946,944 floats.
    assert nbytes == 4 * (32768 * (3 + 416 + 14 + 416) + 531 * 291 + weights) == 115_685_988


def test_gv1_step_and_scene_by_hand():
    cfg = registry.config('gv1')
    # Per query: lin_in 68 x 416, 6 blocks x 3 x 416^2, lin_out 416 x 5,
    # the interpolation 8 x 288, 2 layers x (3 x 416^2 + 9,878,848).
    q = 68 * 416 + 6 * 3 * 416 ** 2 + 416 * 5 + 8 * 288 + 2 * (3 * 416 ** 2 + 9_878_848)
    assert _field.decoder_query_macs(cfg) == q == 23_943_712
    fwd = 3 * (_field.encoder_macs(cfg) + 4 * (17920 * q + 2 * 531 * 2 * 288 * 416))
    assert _field.train_step_flops(cfg) == 3 * 2 * fwd
    f_bwd, _ = _field.train_attention_backward(cfg)
    f_fwd, _ = _field.attention_forward(cfg, 17920)
    assert f_bwd == 3 * 4 * 2 * 2 * f_fwd      # batch 3 x 4 frames x 2 layers, twice.


def test_pyramid_and_abstract_cloud():
    assert _field.pyramid(registry.config('gv1')) == [14336, 4779, 1593, 531]
    assert _field.abstract_points(registry.config('gv1')) == 531
    assert _field.abstract_points(registry.config('cv1')) == 1593 + 531
