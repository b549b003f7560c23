'''
The port's CUDA kernels against their plain PyTorch versions on the card, on
the edge cases the gv1 shapes of chip_smoke.py do not reach: batches of two,
masked keys, exact ties, ragged sizes, every projection mode. Needs an NVIDIA
GPU and nvcc; skips elsewhere (the decision is taken inside the fixture).

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py configures JAX, which a CUDA machine
running only the port need not have.)

Tolerances: kNN, FPS, the bidirectional 1-NN and the eval labels' 1-NN
(nn1_direct) exact (the kernels round like the plain versions);
interpolation atol 1e-5 and attention atol 1e-4 / rtol 1e-3 (the attention
forward's products in 3xTF32 on the tensor cores, another summation order
than cuBLAS); the backward kernels 1e-4 of the largest gradient entry / rtol
1e-3 (weight gradients sum thousands of rows in another order than
autograd).
The backward kernels are also checked to give the same bits twice. The
encoder's fused self-attention kernels (sattn, sattn_bwd) take the attention
tolerances, and the FPS cluster entry is exact like the one-block kernel.
Their bf16 mode (sattn_bf16, sattn_bwd_bf16) takes chip_smoke.py's bf16
gates against the plain bf16 versions, which the f32 kernels fail. The
gathered interpolation's backward (interp_g_bwd) equals its plain version
bit for bit (the same arithmetic in the same order). The eval and train
drivers run end to end on the card at tiny widths. The decoder's module
path (--fused_decoder off, remat on) trains a gv1-width step whose loss is
within 1e-4 of the fused path's; InferenceEngine(store_activations=True)
keeps the outputs bit for bit and its activations within 2e-3 and a
float16 step of the CPU engine's.
'''

import importlib

import numpy as np
import pytest
import torch

t_knn = importlib.import_module('occlusions4d_torch.ops.knn')
t_fps = importlib.import_module('occlusions4d_torch.ops.fps')
t_attn = importlib.import_module('occlusions4d_torch.ops.attention')
t_sattn = importlib.import_module('occlusions4d_torch.ops.self_attention')

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (kernels have no CPU mode)')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _t(a, dev):
    return torch.tensor(np.asarray(a), device=dev)


@pytest.mark.parametrize('K', [1, 5, 16, 32])
@pytest.mark.parametrize('ties', [False, True])
def test_knn_kernels_match_plain(dev, K, ties):
    rng = np.random.RandomState(K)
    if ties:
        k = rng.randint(0, 4, size=(2, 700, 3)).astype(np.float32)
        q = rng.randint(0, 4, size=(2, 333, 3)).astype(np.float32)
    else:
        k = rng.rand(2, 700, 3).astype(np.float32) * 8 - 4
        q = rng.rand(2, 333, 3).astype(np.float32) * 8 - 4
    mask = _t(rng.rand(2, 700) > 0.2, dev)
    for key_mask in (None, mask):
        qq, kk, kn, _ = t_knn._prepare(_t(q, dev), _t(k, dev), key_mask)
        d_p, i_p = t_knn.knn_rank_plain(qq, kk, kn, K)
        d_b, i_b = t_knn.knn_rank(qq, kk, kn, K)
        d_s, i_s = t_knn._pruned_cuda(qq, kk, kn, K, False)
        torch.cuda.synchronize()
        for d, i in ((d_b, i_b), (d_s, i_s)):
            assert torch.equal(i, i_p)
            assert torch.equal(d, d_p)
    # Self search through the public entry (one shared sort).
    pts = _t(k[:, :500], dev)
    a = t_knn.knn(pts, pts, K, pruned=True)
    b = t_knn.knn(pts, pts, K, pruned=False)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])


@pytest.mark.parametrize('K', [1, 14, 32])
@pytest.mark.parametrize('B, N, M', [(1, 5, 700), (3, 5, 2124), (1, 531, 531),
                                     (3, 531, 1593), (1, 32768, 531), (3, 531, 4133),
                                     (1, 2000, 9000)])
def test_knn_brute_lanes_and_stages_match_plain(dev, monkeypatch, B, N, M, K):
    """The brute kernel at 16 and 32 lanes a query (the rule picks 32 at
    N 5 and 531, 16 at 32768) against the plain version, exact: M in one
    shared-memory stage (531 ... 2124) and streamed in 4096-key tiles (4133,
    9000), all keys valid, 80% valid, and fewer valid keys than K (filler
    rows; none valid at K 1)."""
    rng = np.random.RandomState(N + M + K)
    k = rng.rand(B, M, 3).astype(np.float32) * 8 - 4
    q = rng.rand(B, N, 3).astype(np.float32) * 8 - 4
    few = np.zeros((B, M), bool)
    for b in range(B):
        few[b, rng.choice(M, max(K - 3, 0), replace=False)] = True
    for key_mask in (None, rng.rand(B, M) > 0.2, few):
        qq, kk, kn, _ = t_knn._prepare(_t(q, dev), _t(k, dev),
                                       None if key_mask is None else _t(key_mask, dev))
        d_p, i_p = t_knn.knn_rank_plain(qq, kk, kn, K)
        for L in (16, 32):
            monkeypatch.setattr(t_knn, 'brute_lanes', lambda B_, N_: L)
            d_b, i_b = t_knn.knn_rank(qq, kk, kn, K)
            torch.cuda.synchronize()
            assert torch.equal(i_b, i_p), L
            assert torch.equal(d_b, d_p), L


@pytest.mark.parametrize('M', [2124, 5000])
@pytest.mark.parametrize('case', ['one_share_valid', 'nearest_duplicates'])
def test_knn_brute_slot_overflow_matches_plain(dev, monkeypatch, case, M):
    """The brute kernel's rescans when one lane's slots overflow, exact
    against the plain version at 16 and 32 lanes, M in one stage and
    streamed: only keys 0 mod 32 valid (all in lane 0's share; an infinite
    bound passes every one of them), or 600 copies of the nearest key (600
    keys tied at the bound: the vote scan overflows the query's slots and the
    bound moves to the K-th slot held)."""
    rng = np.random.RandomState(M)
    B, N, K = 2, 300, 14
    k = rng.rand(B, M, 3).astype(np.float32) * 8 - 4
    q = rng.rand(B, N, 3).astype(np.float32) * 8 - 4
    mask = None
    if case == 'one_share_valid':
        mask = np.zeros((B, M), bool)
        mask[:, ::32] = True
    else:
        k[:, 1000:1600] = q[:, :1, :] + 1e-3
    qq, kk, kn, _ = t_knn._prepare(_t(q, dev), _t(k, dev),
                                   None if mask is None else _t(mask, dev))
    d_p, i_p = t_knn.knn_rank_plain(qq, kk, kn, K)
    for L in (16, 32):
        monkeypatch.setattr(t_knn, 'brute_lanes', lambda B_, N_: L)
        d_b, i_b = t_knn.knn_rank(qq, kk, kn, K)
        torch.cuda.synchronize()
        assert torch.equal(i_b, i_p), L
        assert torch.equal(d_b, d_p), L


@pytest.mark.parametrize('case', ['plain', 'mask_start', 'n_out_one', 'duplicates'])
def test_fps_kernel_matches_plain(dev, case):
    rng = np.random.RandomState(1)
    B, N, n_out = 2, 1391, 300
    xyz = rng.rand(B, N, 3).astype(np.float32)
    valid = np.ones((B, N), bool)
    start = np.zeros(B, np.int64)
    if case == 'mask_start':
        valid = rng.rand(B, N) > 0.4
        start = np.array([np.flatnonzero(valid[b])[3] for b in range(B)])
    elif case == 'n_out_one':
        n_out, start = 1, np.array([7, 11])
    elif case == 'duplicates':
        xyz = rng.randint(0, 5, size=(B, N, 3)).astype(np.float32)
    args = (_t(xyz, dev), n_out, _t(valid, dev), _t(start, dev))
    assert torch.equal(t_fps._fps_cuda(*args), t_fps.fps_plain(*args))


@pytest.mark.parametrize('premul', [True, False])
def test_interp_and_attention_match_plain(dev, premul):
    rng = np.random.RandomState(2)
    B, N, M, D, E, K = 2, 301, 97, 40, 24, 6
    q_pos = _t(rng.rand(B, N, 3).astype(np.float32), dev)
    pos2 = _t(rng.rand(B, M, 3).astype(np.float32), dev)
    feats = _t(rng.randn(B, M, E).astype(np.float32), dev)
    mask = _t(rng.rand(B, M) > 0.3, dev)
    ki, kd = t_attn.knn_extract(q_pos, pos2, 9, key_mask=mask)
    o_k = t_attn.fused_knn_interp(q_pos, pos2, feats, 5, knn=(ki, kd))
    o_p = t_attn.interp_plain(ki, kd, feats, 5, 1e-4)
    torch.testing.assert_close(o_k, o_p, atol=1e-5, rtol=1e-5)

    def lin(i, o, bias=True):
        p = {'kernel': _t((rng.randn(i, o) / np.sqrt(i)).astype(np.float32), dev)}
        if bias:
            p['bias'] = _t((rng.randn(o) * 0.1).astype(np.float32), dev)
        return p
    params = {'to_k': lin(E, D, False), 'to_v': lin(E, D, False),
              'pos_mlp_0': lin(3, 32), 'pos_mlp_2': lin(32, D),
              'attn_mlp_0': lin(D, 2 * D), 'attn_mlp_2': lin(2 * D, D)}
    q_proj = _t(rng.randn(B, N, D).astype(np.float32), dev)
    out = t_attn.fused_knn_vector_attention(q_proj, q_pos, feats, pos2, params, K,
                                            knn=(ki, kd), premul=premul)
    kv = (torch.cat([feats @ params['to_k']['kernel'], feats @ params['to_v']['kernel']],
                    -1) if premul else feats)
    ref = t_attn.attn_plain(q_pos, q_proj, ki, pos2, kv, params, K, premul)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize('E', [36, 288, 291])
@pytest.mark.parametrize('k', [1, 8, 14])
def test_interp_widths_match_plain(dev, E, k):
    """The index-route interpolation (f32 and bf16) at the encoder's and the
    decoder's widths and one off the 16-byte path (E 291: each column
    loaded and stored on its own), 4100 queries at B 2 (a ragged last
    block), against its plain version (atol 1e-5, rtol 1e-5) and bit for bit
    against the gathered route on the same rows."""
    rng = np.random.RandomState(E + k)
    B, N, M = 2, 4100, 97
    q_pos = _t(rng.rand(B, N, 3).astype(np.float32), dev)
    pos2 = _t(rng.rand(B, M, 3).astype(np.float32), dev)
    feats = _t(rng.randn(B, M, E).astype(np.float32), dev)
    knn = t_attn.knn_extract(q_pos, pos2, 14, key_mask=_t(rng.rand(B, M) > 0.3, dev))
    g = t_attn.knn_gather_rows(pos2, feats, knn, 14)
    for cd in (torch.float32, torch.bfloat16):
        o_k = t_attn.fused_knn_interp(q_pos, pos2, feats, k, knn=knn, compute_dtype=cd)
        o_p = t_attn.interp_plain(knn[0], knn[1], feats, k, 1e-4, cd)
        o_g = t_attn.fused_knn_interp(q_pos, pos2, feats, k, knn=knn, gathered=g,
                                      compute_dtype=cd)
        torch.cuda.synchronize()
        torch.testing.assert_close(o_k, o_p, atol=1e-5, rtol=1e-5)
        assert torch.equal(o_k, o_g), cd


def test_launch_counters_count_kernel_launches(dev):
    from occlusions4d_torch.ops import _build
    _build.reset_launch_counts()
    pts = torch.rand(1, 200, 3, device=dev)
    t_knn.knn(pts, pts, 4)
    t_fps.fps_batched(pts, 20)
    assert _build.launch_counts()['knn_brute'] == 1
    assert _build.launch_counts()['fps'] == 1
    t_knn.knn(pts.cpu(), pts.cpu(), 4)  # plain version: no launch.
    assert _build.launch_counts()['knn_brute'] == 1


def _small_decoder(dev):
    from occlusions4d_torch.models import LocalImplicitField
    torch.manual_seed(0)
    return LocalImplicitField(d_in=4, d_hidden=32, d_out=5, d_latent=32, n_blocks=3,
                              num_local_features=8, local_mode='attention',
                              d_latent_local=16, cross_attn_neighbors=14,
                              cross_attn_layers=2, cr_attn_type='cc').to(dev).eval()


def test_fused_decoder_takes_shared_gather_route_and_matches_cpu(dev):
    '''At SHARED_GATHER_MIN_M+ abstract points the fused decoder launches the
    shared-gather kernels and neither index-route kernel, and agrees with its
    CPU run (plain versions, same route); below the threshold it launches
    the index-route kernels only.'''
    import copy
    from occlusions4d_torch.models.fused import SHARED_GATHER_MIN_M, fused_field_apply
    from occlusions4d_torch.ops import _build
    dec = _small_decoder(dev)
    rng = np.random.RandomState(11)
    q = _t(rng.rand(1, 301, 4).astype(np.float32), dev)
    fg = _t(rng.rand(1, 16).astype(np.float32), dev)
    for M, shared in ((SHARED_GATHER_MIN_M - 1, False), (SHARED_GATHER_MIN_M + 77, True)):
        abstract = _t(rng.rand(1, M, 3 + 16).astype(np.float32), dev)
        _build.reset_launch_counts()
        with torch.no_grad():
            out, _ = fused_field_apply(dec, q, abstract, fg)
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            ref, _ = fused_field_apply(copy.deepcopy(dec).cpu(), q.cpu(), abstract.cpu(),
                                       fg.cpu())
        want = dict(gather=1, interp_g=1, attn_g=2, interp=0, attn=0) if shared else \
            dict(gather=0, interp_g=0, attn_g=0, interp=1, attn=2)
        assert {k: counts[k] for k in want} == want
        torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=1e-3)


def test_shared_gather_backward_launches_kernels_and_matches_cpu(dev):
    '''Autograd through the fused decoder on the shared-gather route launches
    the route's backward kernels (one scatter, one interp_bwd for the
    interpolation's term, one attn_g_bwd per attention layer; no
    interp_g_bwd) and no index-route attention backward, and
    its gradients (abstract features, decoder weights) agree with the CPU
    run (plain versions, same route).'''
    import copy
    from occlusions4d_torch.models.fused import SHARED_GATHER_MIN_M, fused_field_apply
    from occlusions4d_torch.ops import _build
    dec = _small_decoder(dev)
    cpu = copy.deepcopy(dec).cpu()
    rng = np.random.RandomState(12)
    q = rng.rand(1, 301, 4).astype(np.float32)
    fg = rng.rand(1, 16).astype(np.float32)
    abstract = rng.rand(1, SHARED_GATHER_MIN_M + 77, 3 + 16).astype(np.float32)
    grads = []
    for net, d in ((dec, dev), (cpu, torch.device('cpu'))):
        a = _t(abstract, d).requires_grad_(True)
        _build.reset_launch_counts()
        out, _ = fused_field_apply(net, _t(q, d), a, _t(fg, d))
        (out ** 2).sum().backward()
        if d.type == 'cuda':
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            want = dict(scatter=1, interp_g_bwd=0, attn_g_bwd=2, attn_bwd=0,
                        interp_bwd=1)
            assert {k: counts[k] for k in want} == want
        grads.append([a.grad] + [p.grad for p in net.parameters()])
    for g_dev, g_cpu in zip(*grads):
        _close(g_dev.cpu(), g_cpu)


@pytest.mark.parametrize('K', [1, 14, 32])
def test_shared_gather_backward_kernels_match_plain(dev, K):
    '''scatter, interp_g_bwd and attn_g_bwd against their plain versions: B 2,
    masked keys, gathered rows past every consumer's k (k_ext > k where K
    allows), 150 queries on one key (a long scatter segment); the zero rows
    and zero position columns exact; each twice with the same bits. The
    gathered attention backward also gives d(q_proj) and the weight
    gradients of the per-row index route on the same rows, bit for bit.'''
    rng = np.random.RandomState(40 + K)
    B, N, M, D, E = 2, 203, 97, 40, 24
    k_ext = min(K + 4, 32)
    q = rng.rand(B, N, 3).astype(np.float32)
    pos2 = rng.rand(B, M, 3).astype(np.float32)
    q[:, :150] = pos2[:, :1] + 1e-3 * rng.rand(B, 150, 3).astype(np.float32)
    q_pos, pos2 = _t(q, dev), _t(pos2, dev)
    feats = _t(rng.randn(B, M, E).astype(np.float32), dev)
    mask = rng.rand(B, M) > 0.3
    mask[:, 0] = True
    knn = t_attn.knn_extract(q_pos, pos2, k_ext, key_mask=_t(mask, dev))
    ki, kd = knn
    g = t_attn.knn_gather_rows(pos2, feats, knn, k_ext)
    assert int((ki == 0).sum(dim=(1, 2)).min()) >= 150

    dg = _t(rng.randn(B, k_ext, N, E + 3).astype(np.float32), dev)
    d1, d2 = (t_attn.gather_bwd(ki, dg, M, k_ext) for _ in range(2))
    _close(d1, t_attn.gather_bwd_plain(ki, dg, M, k_ext))
    assert torch.equal(d1, d2)

    ki_n = min(K, 8)
    go = _t(rng.randn(B, N, E).astype(np.float32), dev)
    o1, o2 = (t_attn.interp_g_bwd(kd, go, ki_n, k_ext, E, 1e-4) for _ in range(2))
    ref = t_attn.interp_g_bwd_plain(kd, go, ki_n, k_ext, E, 1e-4)
    _close(o1, ref)
    assert torch.equal(o1[:, ki_n:], ref[:, ki_n:]) and torch.equal(o1[..., E:], ref[..., E:])
    assert torch.equal(o1, o2)

    params = _attn_params(rng, dev, D, E)
    q_proj = _t(rng.randn(B, N, D).astype(np.float32), dev)
    go = _t(rng.randn(B, N, D).astype(np.float32), dev)
    dq, dgk, dw = t_attn.attn_g_bwd(q_pos, q_proj, g, params, K, go)
    dq2, dgk2, dw2 = t_attn.attn_g_bwd(q_pos, q_proj, g, params, K, go)
    rq, rg, rw = t_attn.attn_g_bwd_plain(q_pos, q_proj, g, params, K, go)
    iq, _, iw = t_attn.attn_bwd(q_pos, q_proj, ki, pos2, feats, params, K, False, go)
    torch.cuda.synchronize()
    _close(dq, rq)
    _close(dgk, rg)
    assert torch.equal(dgk[:, K:], rg[:, K:]) and torch.equal(dgk[..., E:], rg[..., E:])
    assert set(dw) == set(rw)
    for name in rw:
        _close(dw[name], rw[name])
        assert torch.equal(dw[name], dw2[name]) and torch.equal(dw[name], iw[name]), name
    assert torch.equal(dq, dq2) and torch.equal(dgk, dgk2) and torch.equal(dq, iq)


@pytest.mark.parametrize('K', [1, 14, 32])
def test_shared_gather_kernels_match_plain(dev, K):
    '''gather (bit-equal), interp_g and attn_g against their plain versions,
    and against the index route on the same neighbours: B 2, N not a
    multiple of any tile, masked keys, every consumer reading a k-prefix.'''
    rng = np.random.RandomState(20 + K)
    B, N, M, D, E = 2, 203, 97, 40, 24
    q_pos = _t(rng.rand(B, N, 3).astype(np.float32), dev)
    pos2 = _t(rng.rand(B, M, 3).astype(np.float32), dev)
    feats = _t(rng.randn(B, M, E).astype(np.float32), dev)
    mask = _t(rng.rand(B, M) > 0.3, dev)
    knn = t_attn.knn_extract(q_pos, pos2, K, key_mask=mask)
    ki, kd = knn
    g = t_attn.knn_gather_rows(pos2, feats, knn, K)
    fv = torch.cat([feats, pos2], -1).contiguous()
    assert torch.equal(g, t_attn.gather_rows_plain(fv, ki, K))
    ki_n = min(K, 8)
    o_g = t_attn.fused_knn_interp(q_pos, pos2, feats, ki_n, knn=knn, gathered=g)
    torch.testing.assert_close(o_g, t_attn.interp_g_plain(kd, g, ki_n, 1e-4),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(o_g, t_attn.fused_knn_interp(q_pos, pos2, feats, ki_n, knn=knn))
    params = _attn_params(rng, dev, D, E)
    q_proj = _t(rng.randn(B, N, D).astype(np.float32), dev)
    with torch.no_grad():
        out = t_attn.fused_knn_vector_attention(q_proj, q_pos, feats, pos2, params, K,
                                                knn=knn, gathered=g)
        ref = t_attn.attn_g_plain(q_pos, q_proj, g, params, K)
        idx = t_attn.fused_knn_vector_attention(q_proj, q_pos, feats, pos2, params, K,
                                                knn=knn, premul=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-3)
    assert torch.equal(out, idx)  # same kernel body, same rows: same bits.


def _attn_params(rng, dev, D, E, P=32):
    def lin(i, o, bias=True):
        p = {'kernel': _t((rng.randn(i, o) / np.sqrt(i)).astype(np.float32), dev)}
        if bias:
            p['bias'] = _t((rng.randn(o) * 0.1).astype(np.float32), dev)
        return p
    return {'to_k': lin(E, D, False), 'to_v': lin(E, D, False),
            'pos_mlp_0': lin(3, P), 'pos_mlp_2': lin(P, D),
            'attn_mlp_0': lin(D, 2 * D), 'attn_mlp_2': lin(2 * D, D)}


def _close(a, b):
    scale = max(1.0, float(b.abs().max()))
    torch.testing.assert_close(a, b, atol=1e-4 * scale, rtol=1e-3)


@pytest.mark.parametrize('K', [1, 14, 32])
@pytest.mark.parametrize('premul', [True, False])
def test_attn_bwd_kernel_matches_plain(dev, K, premul):
    rng = np.random.RandomState(K)
    B, N, M, D, E = 2, 203, 97, 40, 24  # N not a multiple of any row tile.
    q_pos = _t(rng.rand(B, N, 3).astype(np.float32), dev)
    pos2 = _t(rng.rand(B, M, 3).astype(np.float32), dev)
    feats = _t(rng.randn(B, M, E).astype(np.float32), dev)
    mask = _t(rng.rand(B, M) > 0.3, dev)
    params = _attn_params(rng, dev, D, E)
    ki, _ = t_attn.knn_extract(q_pos, pos2, K, key_mask=mask)
    kv = (torch.cat([feats @ params['to_k']['kernel'], feats @ params['to_v']['kernel']],
                    -1).contiguous() if premul else feats)
    q_proj = _t(rng.randn(B, N, D).astype(np.float32), dev)
    g = _t(rng.randn(B, N, D).astype(np.float32), dev)
    args = (q_pos, q_proj, ki, pos2, kv, params, K, premul, g)
    dq, dkv, dw = t_attn.attn_bwd(*args)
    dq2, dkv2, dw2 = t_attn.attn_bwd(*args)
    rq, rkv, rw = t_attn.attn_bwd_plain(*args)
    torch.cuda.synchronize()
    _close(dq, rq)
    _close(dkv, rkv)
    assert set(dw) == set(rw)
    for name in rw:
        _close(dw[name], rw[name])
        assert torch.equal(dw[name], dw2[name]), name
    assert torch.equal(dq, dq2) and torch.equal(dkv, dkv2)


# (B, N, M, D, E, K, K_ext, chunks): every case runs the gathered forward
# and both index-route forward kernels; `chunks` > 1 shrinks the per-row
# operand budget so the launch cuts its rows into about that many query
# chunks.
_ATTN_FWD_EDGE = {'k1_n301': (2, 301, 97, 40, 24, 1, 3, 1),
                  'k14_n301': (2, 301, 97, 40, 24, 14, 16, 1),
                  'k32_n301': (2, 301, 97, 40, 24, 32, 32, 1),
                  'k14_n1': (2, 1, 60, 40, 24, 14, 16, 1),
                  'k32_n1': (1, 1, 60, 40, 24, 32, 32, 1),
                  'k14_chunks': (2, 301, 97, 40, 24, 14, 14, 5),
                  'd416_e288': (1, 150, 120, 416, 288, 14, 16, 1),
                  'd448_e320': (1, 150, 120, 448, 320, 14, 16, 1),
                  'd544_e288': (1, 150, 120, 544, 288, 14, 16, 1),
                  'd4_e12': (2, 301, 97, 4, 12, 14, 16, 1)}


@pytest.mark.parametrize('case', sorted(_ATTN_FWD_EDGE))
def test_attn_forward_redesign_edge_shapes(dev, case, monkeypatch):
    '''The tensor-core attention forward (csrc/attn.cu o4d_attn, o4d_attn_g)
    at edge shapes: k 1, 14 and 32, N 1 and 301 (no multiple of the 64-row
    tile), D 40 and E 24 off the 8-column fragments, D 4 with E 12 (theta's
    widest row groups), masked keys, rows
    gathered past k, several query chunks, the gv1 widths D 416, E 288, and
    decoders wider than one 416-column block (D 448 with E 320, D 544).
    attn_g and attn in both projection modes against their plain versions,
    each twice for the same bits; the gathered and per-row index routes
    bit-equal on the same rows.'''
    B, N, M, D, E, K, k_ext, chunks = _ATTN_FWD_EDGE[case]
    if chunks > 1:
        row_bytes = 4 * K * (3 + 32 + 4 * D + max(D, E))
        monkeypatch.setattr(t_attn, '_FWD_BUDGET', row_bytes * (-(-N // chunks)))
    rng = np.random.RandomState(400 + K + N + D)
    q_pos = _t(rng.rand(B, N, 3).astype(np.float32), dev)
    pos2 = _t(rng.rand(B, M, 3).astype(np.float32), dev)
    feats = _t(rng.randn(B, M, E).astype(np.float32), dev)
    mask = _t(rng.rand(B, M) > 0.3, dev)
    params = _attn_params(rng, dev, D, E)
    knn = t_attn.knn_extract(q_pos, pos2, k_ext, key_mask=mask)
    g = t_attn.knn_gather_rows(pos2, feats, knn, k_ext)
    q_proj = _t(rng.randn(B, N, D).astype(np.float32), dev)
    with torch.no_grad():
        og = t_attn._attn_g_cuda(q_pos, q_proj, g, params, K)
        og2 = t_attn._attn_g_cuda(q_pos, q_proj, g, params, K)
        rg = t_attn.attn_g_plain(q_pos, q_proj, g, params, K)
        torch.cuda.synchronize()
        torch.testing.assert_close(og, rg, atol=1e-4, rtol=1e-3)
        assert torch.equal(og, og2)
        for premul in (True, False):
            kv = (torch.cat([feats @ params['to_k']['kernel'],
                             feats @ params['to_v']['kernel']], -1).contiguous()
                  if premul else feats)
            args = (q_pos, q_proj, knn[0], pos2, kv, params, K, premul)
            oi, oi2 = t_attn._attn_cuda(*args), t_attn._attn_cuda(*args)
            ri = t_attn.attn_plain(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(oi, ri, atol=1e-4, rtol=1e-3)
            assert torch.equal(oi, oi2)
            if not premul:
                assert torch.equal(oi, og)


def test_attn_forward_above_the_tile_width_raises(dev):
    '''D above the width whose 64 tile rows fill the block's shared memory
    (o4d_attn_max_width, 560) raises rather than computing something else.'''
    width = t_attn._attn_lib().o4d_attn_max_width()
    assert width == 560
    rng = np.random.RandomState(5)
    B, N, M, D, E, K = 1, 20, 30, width + 8, 24, 6
    q_pos = _t(rng.rand(B, N, 3).astype(np.float32), dev)
    pos2 = _t(rng.rand(B, M, 3).astype(np.float32), dev)
    feats = _t(rng.randn(B, M, E).astype(np.float32), dev)
    params = _attn_params(rng, dev, D, E)
    ki, _ = t_attn.knn_extract(q_pos, pos2, K)
    q_proj = _t(rng.randn(B, N, D).astype(np.float32), dev)
    with pytest.raises(NotImplementedError):
        t_attn._attn_cuda(q_pos, q_proj, ki, pos2, feats, params, K, False)


# (B, N, M, D, E, K, K_ext, chunks): every case runs the gathered and both
# index-route backward kernels; `chunks` > 1 shrinks the per-row operand
# budget so the launch cuts its rows into about that many query chunks.
_ATTN_EDGE = {'n_ragged_k14': (2, 203, 97, 40, 24, 14, 16, 1),
              'k1': (2, 203, 97, 40, 24, 1, 3, 1),
              'k32': (2, 77, 97, 40, 24, 32, 32, 1),
              'd36_h72_e20': (2, 150, 80, 36, 20, 16, 18, 1),
              'b1_chunks': (1, 301, 120, 40, 24, 14, 16, 9),
              'b3_chunks': (3, 203, 97, 40, 24, 14, 14, 4),
              'd448_e320': (1, 150, 120, 448, 320, 14, 16, 1),
              'd544_e288': (1, 150, 120, 544, 288, 14, 16, 1)}


@pytest.mark.parametrize('case', sorted(_ATTN_EDGE))
def test_attn_backward_redesign_edge_shapes(dev, case, monkeypatch):
    '''The chunked tensor-core attention backward (csrc/attn_bwd.cu) at
    edge shapes: N not a multiple of any tile, k 1 and 32, rows gathered
    past k, D, E and H off the 128-wide tiles, B 1, several query chunks
    with a ragged last one. Each of attn_g_bwd, attn_bwd premul and per-row
    against its plain version, twice for the same bits; the zero rows and
    columns of dg exact; d(q_proj) and the weight gradients of the gathered
    and per-row index routes bit-equal.'''
    B, N, M, D, E, K, k_ext, chunks = _ATTN_EDGE[case]
    if chunks > 1:
        row_bytes = 4 * K * (3 + 2 * E + 2 * 32 + 6 * D + 4 * D)
        monkeypatch.setattr(t_attn, '_BWD_BUDGET', row_bytes * (-(-N // chunks)))
    rng = np.random.RandomState(300 + K + N)
    q_pos = _t(rng.rand(B, N, 3).astype(np.float32), dev)
    pos2 = _t(rng.rand(B, M, 3).astype(np.float32), dev)
    feats = _t(rng.randn(B, M, E).astype(np.float32), dev)
    params = _attn_params(rng, dev, D, E)
    knn = t_attn.knn_extract(q_pos, pos2, k_ext)
    ki = knn[0]
    g = t_attn.knn_gather_rows(pos2, feats, knn, k_ext)
    q_proj = _t(rng.randn(B, N, D).astype(np.float32), dev)
    go = _t(rng.randn(B, N, D).astype(np.float32), dev)
    dq, dgk, dw = t_attn.attn_g_bwd(q_pos, q_proj, g, params, K, go)
    dq2, dgk2, dw2 = t_attn.attn_g_bwd(q_pos, q_proj, g, params, K, go)
    rq, rg, rw = t_attn.attn_g_bwd_plain(q_pos, q_proj, g, params, K, go)
    torch.cuda.synchronize()
    _close(dq, rq)
    _close(dgk, rg)
    assert torch.equal(dgk[:, K:], rg[:, K:]) and torch.equal(dgk[..., E:], rg[..., E:])
    assert torch.equal(dq, dq2) and torch.equal(dgk, dgk2)
    assert set(dw) == set(rw)
    for name in rw:
        _close(dw[name], rw[name])
        assert torch.equal(dw[name], dw2[name]), name
    for premul in (False, True):
        kv = (torch.cat([feats @ params['to_k']['kernel'],
                         feats @ params['to_v']['kernel']], -1).contiguous()
              if premul else feats)
        args = (q_pos, q_proj, ki, pos2, kv, params, K, premul, go)
        iq, ikv, iw = t_attn.attn_bwd(*args)
        iq2, ikv2, iw2 = t_attn.attn_bwd(*args)
        pq, pkv, pw = t_attn.attn_bwd_plain(*args)
        torch.cuda.synchronize()
        _close(iq, pq)
        _close(ikv, pkv)
        assert torch.equal(iq, iq2) and torch.equal(ikv, ikv2)
        for name in pw:
            _close(iw[name], pw[name])
            assert torch.equal(iw[name], iw2[name]), name
        if not premul:
            assert torch.equal(iq, dq)
            assert all(torch.equal(iw[name], dw[name]) for name in iw)


@pytest.mark.parametrize('case', ['one_key', 'ke_gt_k', 'skew'])
def test_scatter_kernel_index_and_chunked_sums(dev, case):
    '''The scatter's counting-sort inverse index equals the stable sort of
    scatter_index_plain (rows past k skipped when KE > k), and its chunked
    per-key sums agree with gather_bwd_plain (scatter_add_) and give the same
    bits twice: every row on one key (about 190 summing chunks per
    example), KE > k, and 80% of the rows on one key.'''
    rng = np.random.RandomState(70)
    B, N, M, C, k, KE = 2, 2003, 50, 27, 6, 6
    ki = rng.randint(0, M, size=(B, N, k + 2)).astype(np.int32)
    if case == 'one_key':
        ki[:] = 5
    elif case == 'ke_gt_k':
        KE = 9
    else:
        ki[rng.rand(B, N, k + 2) < 0.8] = 3
    ki = _t(ki, dev)
    dg = _t(rng.randn(B, KE, N, C).astype(np.float32), dev)
    rows, offsets = t_attn.scatter_index(ki, M, k, KE)
    p_rows, p_offsets = t_attn.scatter_index_plain(ki, M, k, KE)
    d1, d2 = (t_attn.gather_bwd(ki, dg, M, k) for _ in range(2))
    ref = t_attn.gather_bwd_plain(ki, dg, M, k)
    torch.cuda.synchronize()
    assert torch.equal(rows, p_rows) and torch.equal(offsets, p_offsets)
    _close(d1, ref)
    assert torch.equal(d1, d2)
    if case == 'one_key':
        assert not d1[:, :5].any() and not d1[:, 6:].any()


@pytest.mark.parametrize('K', [1, 8, 32])
def test_interp_bwd_kernel_matches_plain(dev, K):
    rng = np.random.RandomState(K)
    B, N, M, E = 2, 301, 97, 40
    q_pos = _t(rng.rand(B, N, 3).astype(np.float32), dev)
    pos2 = _t(rng.rand(B, M, 3).astype(np.float32), dev)
    mask = _t(rng.rand(B, M) > 0.3, dev)
    ki, kd = t_attn.knn_extract(q_pos, pos2, K, key_mask=mask)
    g = _t(rng.randn(B, N, E).astype(np.float32), dev)
    d1 = t_attn.interp_bwd(ki, kd, g, M, K, 1e-4)
    d2 = t_attn.interp_bwd(ki, kd, g, M, K, 1e-4)
    ref = t_attn.interp_bwd_plain(ki, kd, g, M, K, 1e-4)
    torch.cuda.synchronize()
    _close(d1, ref)
    assert torch.equal(d1, d2)


@pytest.mark.parametrize('case', ['m2124', 'one_key'])
def test_interp_bwd_kernel_beyond_the_old_cap_and_on_one_key(dev, case):
    '''The counting-sort interp_bwd at M 2124 (above the old shared-memory
    cap of 1816) and with every entry on one key (one run over many summing
    chunks): against its plain version, the same bits twice, and its inverse
    index equal to inverse_index_plain's and to a stable argsort.'''
    rng = np.random.RandomState(11)
    B, N, E, K = 2, 3001, 40, 8
    M = 2124 if case == 'm2124' else 50
    q_pos = _t(rng.rand(B, N, 3).astype(np.float32), dev)
    pos2 = _t(rng.rand(B, M, 3).astype(np.float32), dev)
    ki, kd = t_attn.knn_extract(q_pos, pos2, K)
    if case == 'one_key':
        ki = torch.full_like(ki, 7)
    g = _t(rng.randn(B, N, E).astype(np.float32), dev)
    d1, perm, offsets = t_attn._interp_bwd_launch(ki, kd, g, M, K, 1e-4)
    d2 = t_attn.interp_bwd(ki, kd, g, M, K, 1e-4)
    ref = t_attn.interp_bwd_plain(ki, kd, g, M, K, 1e-4)
    p_ref, o_ref = t_attn.inverse_index_plain(ki, M, K)
    torch.cuda.synchronize()
    _close(d1, ref)
    assert torch.equal(d1, d2)
    assert torch.equal(perm, p_ref) and torch.equal(offsets, o_ref)
    keys = (ki.long() + M * torch.arange(B, device=dev)[:, None, None]).reshape(-1)
    assert torch.equal(perm.long(), torch.argsort(keys, stable=True))
    if case == 'one_key':
        assert not d1[:, :7].any() and not d1[:, 8:].any()


@pytest.mark.parametrize('KI', [4, 10])
def test_scatter_interp_kernel_matches_plain(dev, KI):
    '''The decoder route's backward of the gather and the gathered
    interpolation (the scatter of dg, then interp_bwd of go in the first E
    channels), at k_interp < k_ext and k_interp = k_ext (10), B 2, masked
    keys, 150 queries on one key: against its plain version, the same bits
    twice; without dg (no other consumer of the rows) against the plain
    version too, launching interp_bwd and no scatter.'''
    from occlusions4d_torch.ops import _build
    rng = np.random.RandomState(60 + KI)
    B, N, M, E, k_ext = 2, 203, 97, 24, 10
    q = rng.rand(B, N, 3).astype(np.float32)
    pos2 = rng.rand(B, M, 3).astype(np.float32)
    q[:, :150] = pos2[:, :1] + 1e-3 * rng.rand(B, 150, 3).astype(np.float32)
    mask = rng.rand(B, M) > 0.3
    mask[:, 0] = True
    ki, kd = t_attn.knn_extract(_t(q, dev), _t(pos2, dev), k_ext, key_mask=_t(mask, dev))
    dg = _t(rng.randn(B, k_ext, N, E + 3).astype(np.float32), dev)
    go = _t(rng.randn(B, N, E).astype(np.float32), dev)
    d1, d2 = (t_attn.gather_interp_bwd_split(ki, kd, dg, go, M, k_ext, KI, 1e-4)
              for _ in range(2))
    ref = t_attn.gather_interp_bwd_plain(ki, kd, dg, go, M, k_ext, KI, 1e-4)
    torch.cuda.synchronize()
    before = _build.launch_counts()
    no_dg = t_attn.gather_interp_bwd_split(ki, kd, None, go, M, k_ext, KI, 1e-4)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    no_dg_ref = t_attn.gather_interp_bwd_plain(ki, kd, None, go, M, k_ext, KI, 1e-4)
    torch.cuda.synchronize()
    _close(d1, ref)
    assert torch.equal(d1, d2)
    assert after['interp_bwd'] - before['interp_bwd'] == 1
    assert after['scatter'] == before['scatter']
    _close(no_dg, no_dg_ref)
    assert not no_dg[..., E:].any()


@pytest.mark.parametrize('case', ['carla_scale', 'duplicates'])
def test_nn1_direct_kernel_matches_plain(dev, case):
    '''The eval 1-NN kernel equals its plain version exactly (distances and
    indices): a cloud 40-80 m from the origin with queries about 0.2 from a
    key, and integer grids with duplicate keys (the lowest index wins).'''
    rng = np.random.RandomState(9)
    N, M = 5003, 20011
    if case == 'duplicates':
        keys = rng.randint(0, 8, size=(M, 3)).astype(np.float32)
        query = rng.randint(0, 8, size=(N, 3)).astype(np.float32) + 0.5
    else:
        keys = (rng.rand(M, 3) * [40.0, 30.0, 4.0] + [40.0, -15.0, -1.0]).astype(np.float32)
        step = rng.randn(N, 3)
        step *= rng.uniform(0.195, 0.205, (N, 1)) / np.linalg.norm(step, axis=1, keepdims=True)
        query = (keys[rng.randint(0, M, N)] + step).astype(np.float32)
    qt, kt = _t(query, dev), _t(keys, dev)
    d, i = t_knn.nn1_direct(qt, kt)
    pd, pi = t_knn.nn1_direct_plain(qt, kt)
    torch.cuda.synchronize()
    assert i.dtype == torch.int32 and torch.equal(i, pi) and torch.equal(d, pd)


def test_autograd_runs_backward_kernels(dev):
    from occlusions4d_torch.ops import _build
    rng = np.random.RandomState(5)
    B, N, M, D, E, K = 1, 64, 40, 32, 16, 6
    q_pos = _t(rng.rand(B, N, 3).astype(np.float32), dev)
    pos2 = _t(rng.rand(B, M, 3).astype(np.float32), dev)
    feats = _t(rng.randn(B, M, E).astype(np.float32), dev).requires_grad_(True)
    params = _attn_params(rng, dev, D, E)
    q_proj = _t(rng.randn(B, N, D).astype(np.float32), dev).requires_grad_(True)
    _build.reset_launch_counts()
    knn = t_attn.knn_extract(q_pos, pos2, K)
    y = t_attn.fused_knn_vector_attention(q_proj, q_pos, feats, pos2, params, K, knn=knn)
    z = t_attn.fused_knn_interp(q_pos, pos2, feats, 4, knn=knn)
    (y.sum() + z.sum()).backward()
    counts = _build.launch_counts()
    assert counts['attn_bwd'] == 1 and counts['interp_bwd'] == 1
    assert torch.isfinite(feats.grad).all() and torch.isfinite(q_proj.grad).all()


@pytest.mark.parametrize('case', ['random', 'duplicates'])
def test_nn1_bidir_kernel_matches_plain(dev, case):
    rng = np.random.RandomState(7)
    B, N, M = 2, 1333, 4711  # ragged against the row and key tiles.
    if case == 'duplicates':
        a = rng.randint(0, 6, size=(B, N, 3)).astype(np.float32)
        b = rng.randint(0, 6, size=(B, M, 3)).astype(np.float32)
        b[:, :500] = a[:, :500]
    else:
        a = rng.rand(B, N, 3).astype(np.float32) * 8 - 4
        b = rng.rand(B, M, 3).astype(np.float32) * 8 - 4
    am = _t(rng.rand(B, N) > 0.2, dev)
    bm = _t(rng.rand(B, M) > 0.2, dev)
    a, b = _t(a, dev), _t(b, dev)
    for masks in ((None, None), (am, bm)):
        an, bn = t_knn.sq_norm(a), t_knn.sq_norm(b)
        if masks[0] is not None:
            an = torch.where(masks[0], an, torch.full_like(an, float('inf')))
            bn = torch.where(masks[1], bn, torch.full_like(bn, float('inf')))
        ka, kb = t_knn.nn1_bidir_rank(a, an, b, bn)
        pa, pb = t_knn.nn1_bidir_plain(a, an, b, bn)
        torch.cuda.synchronize()
        assert torch.equal(ka, pa) and torch.equal(kb, pb)


def _sattn_case(rng, dev, B, N, K, D, E=None):
    E = D if E is None else E
    q = _t(rng.randn(B, N, D).astype(np.float32), dev)
    gf = _t(rng.randn(B, N, K, E).astype(np.float32), dev)
    rel = _t((rng.rand(B, N, K, 3) * 2 - 1).astype(np.float32), dev)
    return q, gf, rel, _attn_params(rng, dev, D, E)


# (D, E) of the self-attention kernels' card tests: the encoder's widths
# (feature sizes 36 and 40 reach D = E = 36 to 320, each level its own
# column block of the forward's tile), E != D both ways (a narrow block
# with wide rows, a wide block with narrow rows) and D 4, where theta's row
# groups reach their cap.
_SATTN_DIMS = [(36, 36), (72, 72), (144, 144), (288, 288), (320, 320), (36, 288), (144, 40),
               (4, 4), (4, 20)]
_SATTN_IDS = [f'd{d}_e{e}' for d, e in _SATTN_DIMS]


@pytest.mark.parametrize('K', [8, 16, 32])
@pytest.mark.parametrize('D,E', _SATTN_DIMS, ids=_SATTN_IDS)
def test_sattn_kernels_match_plain(dev, K, D, E):
    '''o4d_sattn and o4d_sattn_bwd against their plain versions at odd N
    (ragged against every query tile), B 2, the encoder's widths: the
    forward, d(q), d(gf) and the ten weight gradients; each twice with the
    same bits.'''
    rng = np.random.RandomState(60 + K + D + E)
    B, N = 2, 203
    q, gf, rel, params = _sattn_case(rng, dev, B, N, K, D, E)
    with torch.no_grad():
        out = t_sattn.fused_gathered_attention(q, gf, rel, params, K)
        out2 = t_sattn.fused_gathered_attention(q, gf, rel, params, K)
        ref = t_sattn.sattn_plain(q, gf, rel, params)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-3)
    assert torch.equal(out, out2)
    go = _t(rng.randn(B, N, D).astype(np.float32), dev)
    dq, dgf, dw = t_sattn.sattn_bwd(q, gf, rel, params, K, go)
    dq2, dgf2, dw2 = t_sattn.sattn_bwd(q, gf, rel, params, K, go)
    rq, rgf, rw = t_sattn.sattn_bwd_plain(q, gf, rel, params, go)
    torch.cuda.synchronize()
    _close(dq, rq)
    _close(dgf, rgf)
    assert set(dw) == set(rw) and len(rw) == 10
    for name in rw:
        _close(dw[name], rw[name])
        assert torch.equal(dw[name], dw2[name]), name
    assert torch.equal(dq, dq2) and torch.equal(dgf, dgf2)


def test_sattn_forward_in_query_chunks_and_above_the_tile_width(dev, monkeypatch):
    '''o4d_sattn and o4d_sattn_bf16 with the per-row budget shrunk so that
    each example's queries run in five chunks (the last short) give the bits
    of one chunk (every kernel of the pipeline is row-local); max(D, E)
    above the tile's 560 raises.'''
    rng = np.random.RandomState(64)
    B, N, K, D = 2, 301, 16, 72
    q, gf, rel, params = _sattn_case(rng, dev, B, N, K, D)
    with torch.no_grad():
        whole = [t_sattn.fused_gathered_attention(q, gf, rel, params, K, compute_dtype=cd)
                 for cd in (torch.float32, torch.bfloat16)]
        monkeypatch.setattr(t_attn, '_FWD_BUDGET', 4 * K * 3 * D * (-(-N // 5)))
        parts = [t_sattn.fused_gathered_attention(q, gf, rel, params, K, compute_dtype=cd)
                 for cd in (torch.float32, torch.bfloat16)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(whole, parts))
    torch.testing.assert_close(whole[0], t_sattn.sattn_plain(q, gf, rel, params),
                               atol=1e-4, rtol=1e-3)
    width = t_attn._attn_lib().o4d_attn_max_width()
    q, gf, rel, params = _sattn_case(rng, dev, 1, 9, 8, 36, width + 8)
    with pytest.raises(NotImplementedError):
        t_sattn.fused_gathered_attention(q, gf, rel, params, 8)


@pytest.mark.parametrize('N', [200, 201, 202, 203])
@pytest.mark.parametrize('k', [1, 8, 14])
@pytest.mark.parametrize('E', [30, 288])
def test_interp_g_bwd_kernel_bit_equal_to_plain(dev, N, k, E):
    '''o4d_interp_g_bwd (a group of 32 queries' rows written as one run per
    plane) equals interp_g_bwd_plain bit for bit, zeros included, B 2: N = 0
    to 3 mod 4 (the runs' 16-byte offsets differ plane by plane; the last
    group short), E + 3 = 33 and 291, k 1, 8 and K_ext 14 (no zero planes); zero and negative
    squared distances; twice with the same bits.'''
    rng = np.random.RandomState(90 + N + k + E)
    B, KS, k_ext = 2, 16, 14
    kd = rng.rand(B, N, KS).astype(np.float32) * 4
    kd[:, :7, 0] = 0.0
    kd[:, 7:9, 0] = -1e-7
    kd = _t(kd, dev)
    go = _t(rng.randn(B, N, E).astype(np.float32), dev)
    o1, o2 = (t_attn.interp_g_bwd(kd, go, k, k_ext, E, 1e-4) for _ in range(2))
    ref = t_attn.interp_g_bwd_plain(kd, go, k, k_ext, E, 1e-4)
    torch.cuda.synchronize()
    assert torch.equal(o1, ref) and torch.equal(o1, o2)
    assert not o1[:, k:].any() and not o1[..., E:].any()


def test_fused_self_attention_module_launches_kernels_and_matches_chain(dev):
    '''VectorAttention(fused='on') on the card launches gather, sattn and,
    in the backward, sattn_bwd and scatter once each, and agrees with the
    'auto' chain in the output and every gradient.'''
    from occlusions4d_torch.models import VectorAttention
    from occlusions4d_torch.ops import _build
    torch.manual_seed(3)
    rng = np.random.RandomState(4)
    att = VectorAttention(24, num_neighbors=16, fused='on').to(dev)
    x = _t(rng.randn(2, 301, 24).astype(np.float32), dev)
    pos = _t(rng.rand(2, 301, 3).astype(np.float32), dev)
    res = {}
    for mode in ('on', 'auto'):
        att.fused = mode
        xx = x.clone().requires_grad_(True)
        _build.reset_launch_counts()
        y = att(xx, pos)
        grads = torch.autograd.grad((y.sin() * 3).sum(), [xx] + list(att.parameters()))
        torch.cuda.synchronize()
        res[mode] = (y, grads, _build.launch_counts())
    want = dict(gather=1, scatter=1, sattn=1, sattn_bwd=1)
    assert {k: res['on'][2][k] for k in want} == want
    assert res['auto'][2]['sattn'] == 0 and res['auto'][2]['sattn_bwd'] == 0
    torch.testing.assert_close(res['on'][0], res['auto'][0], atol=1e-4, rtol=1e-3)
    for a, b in zip(res['on'][1], res['auto'][1]):
        _close(a, b)


@pytest.mark.parametrize('N', [19201, 30000, 57344])
def test_fps_cluster_kernel_matches_plain(dev, N):
    '''The cluster entry (N above the one-block cap) against the plain loop,
    exactly: B 2 with a random start and an invalid-point mask on example 1,
    and duplicated points (exact distance ties).'''
    rng = np.random.RandomState(N)
    B, n_out = 2, 700
    xyz = rng.rand(B, N, 3).astype(np.float32) * 8 - 4
    xyz[:, N // 2:N // 2 + 900] = xyz[:, :900]           # duplicates.
    xyz[1, -2000:] = np.round(xyz[1, -2000:])             # ties on a grid.
    valid = np.ones((B, N), bool)
    valid[1] = rng.rand(N) > 0.3
    start = np.array([0, int(np.flatnonzero(valid[1])[17])])
    from occlusions4d_torch.ops import _build
    _build.reset_launch_counts()
    args = (_t(xyz, dev), n_out, _t(valid, dev), _t(start, dev))
    got = t_fps._fps_cuda(*args)
    assert _build.launch_counts()['fps_cluster'] == 1
    assert torch.equal(got, t_fps.fps_plain(*args))


def test_fps_above_the_cluster_cap_raises(dev):
    '''No cap: at N 200000 FPS runs (points in device memory) and equals the
    plain loop pick for pick: B 2, a random start, an invalid-point mask on
    example 1, duplicated points and ties on a grid.'''
    rng = np.random.RandomState(200000)
    B, N, n_out = 2, 200000, 2048
    xyz = rng.rand(B, N, 3).astype(np.float32) * 8 - 4
    xyz[:, N // 2:N // 2 + 900] = xyz[:, :900]
    xyz[1, -5000:] = np.round(xyz[1, -5000:])
    valid = np.ones((B, N), bool)
    valid[1] = rng.rand(N) > 0.3
    start = np.array([int(rng.randint(N)), int(np.flatnonzero(valid[1])[17])])
    args = (_t(xyz, dev), n_out, _t(valid, dev), _t(start, dev))
    assert torch.equal(t_fps._fps_cuda(*args), t_fps.fps_plain(*args))


@pytest.mark.parametrize('plan', [(1, 256), (1, 1024), (2, 256), (5, 256), (8, 256)])
def test_fps_every_cluster_and_block_size(dev, plan):
    '''Every launch shape of the FPS kernel (cluster size, block size; points
    in registers with 256 threads, in device memory with 1024) against the
    plain loop: B 3, N not a multiple of any block, an invalid-point mask, a
    random start, duplicates.'''
    C, T = plan
    rng = np.random.RandomState(C * T)
    B, n_out = 3, 300
    N = 4001 if T == 256 else 30001
    xyz = rng.rand(B, N, 3).astype(np.float32) * 8 - 4
    xyz[:, -300:] = xyz[:, :300]
    valid = rng.rand(B, N) > 0.2
    start = np.array([int(np.flatnonzero(valid[b])[b * 5]) for b in range(B)])
    args = (_t(xyz, dev), n_out, _t(valid, dev), _t(start, dev))
    assert torch.equal(t_fps._fps_cuda(*args, plan=plan), t_fps.fps_plain(*args))


def _sampler_like(rng, B, N, M, far=False):
    '''Keys uniform in a 10 x 10 x 5 box (20% masked); queries jittered 0.2 to
    0.6 from random keys, as the sampler's air pools draw them, or (far)
    moved up to 30 units further out.'''
    k = rng.rand(B, M, 3).astype(np.float32) * 10 - 5
    k[..., 2] = np.abs(k[..., 2])
    u = rng.randn(B, N, 3)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    q = np.take_along_axis(k, rng.randint(0, M, (B, N))[..., None], 1) \
        + u * (0.2 + 0.4 * rng.rand(B, N, 1))
    if far:
        q = q + np.sign(q) * rng.rand(B, N, 1) * 30
    return q.astype(np.float32), k, rng.rand(B, M) > 0.2


@pytest.mark.parametrize('case', ['sampler_k1', 'far_queries_k1', 'far_queries_k16',
                                  'one_valid_key', 'grid_ties_k8', 'ragged_k32'])
def test_knn_pruned_kernel_matches_plain(dev, case):
    '''The pruned entry (preparation kernels, sorts, pruned kernel) equals the
    brute-force kernel and the plain version exactly, distances and
    indices: the sampler's cross search at K 1 with masked keys; queries far
    outside the keys' box (the seed block and the visiting order matter
    most); all keys but one masked (filler rows: index 0 at +inf past it);
    integer-grid duplicates and ties; N and M off the tile and block sizes.'''
    rng = np.random.RandomState(len(case))
    K, mask = 1, None
    if case in ('sampler_k1', 'far_queries_k1', 'far_queries_k16'):
        q, k, mask = _sampler_like(rng, 3, 2333, 7001, far=case.startswith('far'))
        K = 16 if case.endswith('k16') else 1
    elif case == 'one_valid_key':
        q, k, _ = _sampler_like(rng, 2, 500, 3000)
        mask = np.zeros((2, 3000), bool)
        mask[:, 1234] = True
        K = 4
    elif case == 'grid_ties_k8':
        k = rng.randint(0, 6, size=(2, 5000, 3)).astype(np.float32)
        q = rng.randint(0, 6, size=(2, 1200, 3)).astype(np.float32)
        K = 8
    else:
        k = rng.rand(1, 4097, 3).astype(np.float32)
        q = rng.rand(1, 333, 3).astype(np.float32)
        K = 32
    qq, kk, kn, _ = t_knn._prepare(_t(q, dev), _t(k, dev),
                                   None if mask is None else _t(mask, dev))
    d_s, i_s = t_knn._pruned_cuda(qq, kk, kn, K, False)
    d_b, i_b = t_knn.knn_rank(qq, kk, kn, K)
    d_p, i_p = t_knn.knn_rank_plain(qq, kk, kn, K)
    torch.cuda.synchronize()
    assert torch.equal(d_b, d_p) and torch.equal(i_b, i_p)
    assert torch.equal(d_s, d_p) and torch.equal(i_s, i_p)
    if case == 'one_valid_key':
        assert (i_s[..., 0] == 1234).all() and torch.isinf(d_s[..., 1:]).all()
        assert (i_s[..., 1:] == 0).all()


def test_knn_pruned_preparation_matches_plain(dev):
    '''The preparation kernels give the operands of ops/knn.py pruned_inputs:
    the keys' box, the Hilbert codes of both sets, and (through the sorts)
    the same order.'''
    from occlusions4d_torch.ops import _build
    rng = np.random.RandomState(9)
    q, k, mask = _sampler_like(rng, 2, 1000, 3001)
    qq, kk, kn, _ = t_knn._prepare(_t(q, dev), _t(k, dev), _t(mask, dev))
    lib = t_knn._pruned_lib()
    ref = t_knn.pruned_inputs(qq, kk, kn, False, lib.o4d_knn_prune_tile(),
                              lib.o4d_knn_prune_block())
    lo, hi = kk.amin(1, keepdim=True), kk.amax(1, keepdim=True)
    ck = torch.empty((2, 3001), dtype=torch.int32, device=dev)
    cq = torch.empty((2, 1000), dtype=torch.int32, device=dev)
    lohi = torch.empty((2, 6), device=dev)
    _build.check(lib.o4d_knn_prune_codes(_build.ptr(kk), _build.ptr(qq), _build.ptr(lohi),
                                         _build.ptr(ck), _build.ptr(cq), 2, 1000, 3001,
                                         _build.stream_ptr(dev)), 'codes')
    torch.cuda.synchronize()
    assert torch.equal(lohi, torch.cat([lo, hi], -1)[:, 0])
    assert torch.equal(ck, t_knn.hilbert_codes(kk, lo, hi))
    assert torch.equal(cq, t_knn.hilbert_codes(qq, lo, hi))
    assert torch.equal(torch.sort(ck, dim=-1, stable=True).values, ref['kcode'])
    assert torch.equal(torch.sort(cq, dim=-1, stable=True).values, ref['qcode'])


def test_knn_above_the_pruned_key_limit_takes_the_brute_kernel(dev):
    '''One key above the pruned kernel's limit: PRUNED_MAX_KEYS is the
    kernel's own (o4d_knn_pruned_max_keys), knn (pruned=None) takes the
    brute kernel there and equals the plain version, masked keys included,
    and the pruned entry, asked for explicitly, raises.'''
    from occlusions4d_torch.ops import _build
    M = t_knn.PRUNED_MAX_KEYS + 1
    assert t_knn.PRUNED_MAX_KEYS == t_knn._pruned_lib().o4d_knn_pruned_max_keys()
    rng = np.random.RandomState(5)
    k = _t(rng.rand(1, M, 3).astype(np.float32) * 100 - 50, dev)
    q = _t(rng.rand(1, 40, 3).astype(np.float32) * 100 - 50, dev)
    mask = _t(rng.rand(1, M) > 0.2, dev)
    _build.reset_launch_counts()
    d, i = t_knn.knn(q, k, 16, key_mask=mask, euclidean=False)
    counts = _build.launch_counts()
    assert counts['knn_brute'] == 1 and counts['knn_pruned'] == 0
    qq, kk, kn, _ = t_knn._prepare(q, k, mask)
    d_p, i_p = t_knn.knn_rank_plain(qq, kk, kn, 16)
    torch.cuda.synchronize()
    assert torch.equal(i, i_p)
    assert torch.equal(d, torch.clamp(d_p + t_knn.sq_norm(qq)[..., None], min=0.0))
    with pytest.raises(NotImplementedError):
        t_knn.knn_pruned(q, k, 16, key_mask=mask)


@pytest.mark.parametrize('dims', [(448, 320), (544, 288)])
def test_wide_decoder_matches_cpu(dev, dims):
    '''Decoders wider than one 416-column block (D 448 with E 320, the JAX
    CLI's --pt_feat_dim 40; D 544 with E 288, its --global_size 256) through
    fused_field_apply on the index route: the output and, through autograd,
    d(abstract) and every decoder gradient agree with the CPU run (plain
    versions); both attention layers launch their kernels.'''
    import copy
    from occlusions4d_torch.models import LocalImplicitField
    from occlusions4d_torch.models.fused import fused_field_apply
    from occlusions4d_torch.ops import _build
    D, E = dims
    torch.manual_seed(1)
    dec = LocalImplicitField(d_in=4, d_hidden=D, d_out=5, d_latent=D, n_blocks=2,
                             num_local_features=8, local_mode='attention',
                             d_latent_local=E, cross_attn_neighbors=14,
                             cross_attn_layers=2, cr_attn_type='cc').to(dev)
    cpu = copy.deepcopy(dec).cpu()
    rng = np.random.RandomState(D)
    q = rng.rand(1, 301, 4).astype(np.float32)
    fg = rng.randn(1, D - E).astype(np.float32)
    abstract = rng.rand(1, 531, 3 + E).astype(np.float32)
    res = []
    for net, d in ((dec, dev), (cpu, torch.device('cpu'))):
        a = _t(abstract, d).requires_grad_(True)
        _build.reset_launch_counts()
        out, _ = fused_field_apply(net, _t(q, d), a, _t(fg, d))
        (out ** 2).sum().backward()
        if d.type == 'cuda':
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            assert counts['attn'] == 2 and counts['attn_bwd'] == 2
        res.append([out.detach(), a.grad] + [p.grad for p in net.parameters()])
    for x, y in zip(*res):
        _close(x.cpu(), y)


def test_wide_decoder_trainer_step(dev):
    '''One Trainer step with a D 448 decoder (--pt_feat_dim 40: E 320) on the
    card, batch 1, one frame: finite losses, gradients and parameters, the
    parameters change, and the decoder's attention kernels run both ways.'''
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.ops import _build
    from occlusions4d_torch.train import Trainer
    cfg = TrainConfig(n_points=1024, pt_feat_dim=40, up_down_blocks=3, transition_factor=3,
                      pt_num_neighbors=16, down_neighbors=12, global_size=128,
                      implicit_mlp_blocks=2, cross_attn_layers=2, cross_attn_neighbors=14,
                      cr_attn_type='cc', color_mode='rgb_nosigmoid', cr_cube_bounds=5.0,
                      min_z=-1.0, num_cr_local_feats=8, color_lw=1.0, density_lw=1.0,
                      segmentation_lw=0.0, point_occupancy_radius=0.2,
                      air_sampling_ratio=1.5, num_cr_solid=512, past_frames=1,
                      future_frames=0, batch_size=1, point_sample_bias='none')
    tr = Trainer(cfg, 'greater', 'cuda').init_state(seed=0)
    rng = np.random.RandomState(3)
    B, N, T, M = 1, 1024, 1, 2048
    tgt = np.zeros((B, T, M, 9), np.float32)
    tgt[..., :3] = rng.rand(B, T, M, 3) * 10 - 5
    tgt[..., 2] = np.abs(tgt[..., 2])
    tgt[..., 5:8] = rng.rand(B, T, M, 3)
    batch = dict(pcl_input=(rng.rand(B, N, 8) * 2 - 1).astype(np.float32),
                 pcl_target=tgt, pcl_target_valid=np.ones((B, T, M), bool),
                 valo_ids=np.tile(np.arange(32, dtype=np.int32), (B, 1)),
                 num_valo_ids=np.full((B,), 8, np.int32))
    batch = {k: _t(v, dev) for k, v in batch.items()}
    before = [p.detach().clone() for p in tr.optimizer.params]
    _build.reset_launch_counts()
    m = tr.step(batch)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    assert np.isfinite(float(m['total_loss']))
    assert bool(m['grads_finite']) and bool(m['params_finite'])
    assert counts['attn'] > 0 and counts['attn_bwd'] > 0
    assert any(not torch.equal(p, q) for p, q in zip(tr.optimizer.params, before))


# ------------------------------------------------------------ bf16 mode --
# The bf16 kernels (o4d_*_bf16, the engine's precision='fast') against their
# plain bf16 versions: the gather exact; the interpolation atol 1e-5, rtol
# 1e-5 (the f32 gates: exact bf16 products, f32 sums); the attention within
# relative L2 2e-4 and a largest error of 5e-3 of max |out| (the tensor
# core's f32 accumulation in another order than cuBLAS may move an f32
# intermediate by an ulp, and with it a bf16 operand by one bf16 ulp).

def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _bf16_close(a, b):
    assert _rel_l2(a, b) <= 2e-4, _rel_l2(a, b)
    assert float((a - b).abs().max()) <= 5e-3 * float(b.abs().max())


@pytest.mark.parametrize('case', sorted(_ATTN_FWD_EDGE))
def test_bf16_attn_forward_edge_shapes(dev, case, monkeypatch):
    '''o4d_attn_bf16 (both projection modes) and o4d_attn_g_bf16 at the f32
    tile's edge shapes against attn_plain / attn_g_plain in bf16, each twice
    for the same bits; the gathered and per-row index routes bit-equal on
    the same rows, from the bf16 gather's rows or the f32 gather's (the
    kernel rounds them as it loads them).'''
    B, N, M, D, E, K, k_ext, chunks = _ATTN_FWD_EDGE[case]
    if chunks > 1:
        row_bytes = 4 * K * (3 + 32 + 4 * D + max(D, E))
        monkeypatch.setattr(t_attn, '_FWD_BUDGET', row_bytes * (-(-N // chunks)))
    rng = np.random.RandomState(700 + K + N + D)
    q_pos = _t(rng.rand(B, N, 3).astype(np.float32), dev)
    pos2 = _t(rng.rand(B, M, 3).astype(np.float32), dev)
    feats = _t(rng.randn(B, M, E).astype(np.float32), dev)
    mask = _t(rng.rand(B, M) > 0.3, dev)
    params = _attn_params(rng, dev, D, E)
    knn = t_attn.knn_extract(q_pos, pos2, k_ext, key_mask=mask)
    g = t_attn.knn_gather_rows(pos2, feats, knn, k_ext, compute_dtype=torch.bfloat16)
    g32 = t_attn.knn_gather_rows(pos2, feats, knn, k_ext)
    q_proj = _t(rng.randn(B, N, D).astype(np.float32), dev)
    bf = torch.bfloat16
    with torch.no_grad():
        og = t_attn._attn_g_cuda(q_pos, q_proj, g, params, K, True)
        og2 = t_attn._attn_g_cuda(q_pos, q_proj, g32, params, K, True)
        rg = t_attn.attn_g_plain(q_pos, q_proj, g, params, K, bf)
        torch.cuda.synchronize()
        _bf16_close(og, rg)
        assert torch.equal(og, og2)
        for premul in (True, False):
            kv = (torch.cat([feats @ params['to_k']['kernel'],
                             feats @ params['to_v']['kernel']], -1).contiguous()
                  if premul else feats)
            args = (q_pos, q_proj, knn[0], pos2, kv, params, K, premul)
            oi, oi2 = t_attn._attn_cuda(*args, True), t_attn._attn_cuda(*args, True)
            ri = t_attn.attn_plain(*args, bf)
            torch.cuda.synchronize()
            _bf16_close(oi, ri)
            assert torch.equal(oi, oi2)
            if not premul:
                assert torch.equal(oi, og)
            # The bf16 mode is not the f32 one, and within JAX's 3e-2 of it.
            o32 = t_attn._attn_cuda(*args)
            assert not torch.equal(oi, o32)
            assert float((oi - o32).abs().max()) < 3e-2 * float(o32.abs().max())


@pytest.mark.parametrize('K', [1, 14, 32])
def test_bf16_gather_and_interp_kernels_match_plain(dev, K):
    '''o4d_gather_bf16 (exact), o4d_interp_bf16 and o4d_interp_g_bf16 against
    their plain bf16 versions, twice for the same bits, the two
    interpolation routes bit-equal on the same rows; the launch counters
    count the bf16 names only.'''
    from occlusions4d_torch.ops import _build
    rng = np.random.RandomState(60 + K)
    B, N, M, E = 2, 203, 97, 24
    bf = torch.bfloat16
    q_pos = _t(rng.rand(B, N, 3).astype(np.float32), dev)
    pos2 = _t(rng.rand(B, M, 3).astype(np.float32), dev)
    feats = _t(rng.randn(B, M, E).astype(np.float32), dev)
    mask = _t(rng.rand(B, M) > 0.3, dev)
    knn = t_attn.knn_extract(q_pos, pos2, K, key_mask=mask)
    ki, kd = knn
    _build.reset_launch_counts()
    g = t_attn.knn_gather_rows(pos2, feats, knn, K, compute_dtype=bf)
    fv = torch.cat([feats, pos2], -1).contiguous()
    assert torch.equal(g, t_attn.gather_rows_plain(fv, ki, K, bf))
    assert torch.equal(g, t_attn.round_bf16(t_attn.knn_gather_rows(pos2, feats, knn, K)))
    ki_n = min(K, 8)
    o_g = t_attn.fused_knn_interp(q_pos, pos2, feats, ki_n, knn=knn, gathered=g,
                                  compute_dtype=bf)
    o_i = t_attn.fused_knn_interp(q_pos, pos2, feats, ki_n, knn=knn, compute_dtype=bf)
    o_i2 = t_attn.fused_knn_interp(q_pos, pos2, feats, ki_n, knn=knn, compute_dtype=bf)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    torch.testing.assert_close(o_g, t_attn.interp_g_plain(kd, g, ki_n, 1e-4, bf),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(o_i, t_attn.interp_plain(ki, kd, feats, ki_n, 1e-4, bf),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(o_g, o_i) and torch.equal(o_i, o_i2)
    assert {k: counts[k] for k in ('gather_bf16', 'interp_bf16', 'interp_g_bf16', 'gather',
                                   'interp', 'interp_g')} == dict(
        gather_bf16=1, interp_bf16=2, interp_g_bf16=1, gather=1, interp=0, interp_g=0)


def test_fast_decoder_launches_bf16_kernels_and_matches_cpu(dev):
    '''fused_field_apply(compute_dtype=bf16) on both routes launches the bf16
    kernels and no f32 interpolation, gather or attention kernel, and agrees
    with its CPU run (plain bf16 versions, f32 backbone) within relative L2
    1e-2 (the card runs the backbone's nn.Linear layers in TF32); the global
    matmul precision is restored after the call.'''
    import copy
    from occlusions4d_torch.models.fused import SHARED_GATHER_MIN_M, fused_field_apply
    from occlusions4d_torch.ops import _build
    dec = _small_decoder(dev)
    rng = np.random.RandomState(12)
    q = _t(rng.rand(1, 301, 4).astype(np.float32), dev)
    fg = _t(rng.rand(1, 16).astype(np.float32), dev)
    before = torch.get_float32_matmul_precision()
    f32_names = ('gather', 'interp', 'interp_g', 'attn', 'attn_g')
    for M, shared in ((SHARED_GATHER_MIN_M - 1, False), (SHARED_GATHER_MIN_M + 77, True)):
        abstract = _t(rng.rand(1, M, 3 + 16).astype(np.float32), dev)
        _build.reset_launch_counts()
        with torch.no_grad():
            out, _ = fused_field_apply(dec, q, abstract, fg, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            ref, _ = fused_field_apply(copy.deepcopy(dec).cpu(), q.cpu(), abstract.cpu(),
                                       fg.cpu(), compute_dtype=torch.bfloat16)
        want = dict(gather_bf16=1, interp_g_bf16=1, attn_g_bf16=2, interp_bf16=0,
                    attn_bf16=0) if shared else \
            dict(gather_bf16=0, interp_g_bf16=0, attn_g_bf16=0, interp_bf16=1, attn_bf16=2)
        want.update({k: 0 for k in f32_names})
        assert {k: counts[k] for k in want} == want
        assert _rel_l2(out.cpu(), ref) <= 1e-2, _rel_l2(out.cpu(), ref)
        assert torch.get_float32_matmul_precision() == before


# ------------------------------------------------------- bf16 train mode --
# The bf16 backward kernels (o4d_attn_bwd_bf16, o4d_attn_g_bwd_bf16,
# o4d_interp_bwd_bf16, o4d_scatter_bf16; fused_decoder_dtype='bf16') against
# their plain bf16 versions, each gradient within a relative L2 gate: 1e-3
# for the per-key sums; 5e-3 for the attention, whose weight gradients sum
# thousands of rows in another order than cuBLAS before their one rounding
# to bf16, so an entry may land one bf16 ulp (2^-8 relative) away (and a
# ReLU mask may flip where h1 lies within an f32 rounding of zero, an f32
# intermediate may round to the neighbouring bf16 operand); the logits'
# bias, whose true gradient is zero (and any gradient the plain version
# gives as exact zeros: at k 1 the softmax is constant), within 1e-4
# absolute; the f32 kernels
# land outside the gates; each kernel gives the same bits twice.

def _bf16_grad_close(a, b, name='', gate=5e-3):
    if name == ('attn_mlp_2', 'bias') or not bool(b.any()):  # a zero true gradient.
        assert float((a - b).abs().max()) <= 1e-4, name
        return
    assert _rel_l2(a, b) <= gate, (name, _rel_l2(a, b))


@pytest.mark.parametrize('case', sorted(_ATTN_EDGE))
def test_bf16_attn_backward_edge_shapes(dev, case, monkeypatch):
    '''o4d_attn_g_bwd_bf16 and o4d_attn_bwd_bf16 (premul and per-row) at the
    f32 kernels' edge shapes (ragged query chunks, k < k_ext, D 448 and 544)
    against attn_g_bwd_plain / attn_bwd_plain in bf16, each twice for the
    same bits; dg's zero rows and columns exact; d(q_proj) and the weight
    gradients of the gathered and per-row index routes bit-equal; the f32
    kernel's d(q_proj) outside the gate.'''
    B, N, M, D, E, K, k_ext, chunks = _ATTN_EDGE[case]
    if chunks > 1:
        row_bytes = 4 * K * (3 + 2 * E + 2 * 32 + 6 * D + 4 * D)
        monkeypatch.setattr(t_attn, '_BWD_BUDGET', row_bytes * (-(-N // chunks)))
    bf = torch.bfloat16
    rng = np.random.RandomState(800 + K + N)
    q_pos = _t(rng.rand(B, N, 3).astype(np.float32), dev)
    pos2 = _t(rng.rand(B, M, 3).astype(np.float32), dev)
    feats = _t(rng.randn(B, M, E).astype(np.float32), dev)
    params = _attn_params(rng, dev, D, E)
    knn = t_attn.knn_extract(q_pos, pos2, k_ext)
    g = t_attn.knn_gather_rows(pos2, feats, knn, k_ext, compute_dtype=bf)
    q_proj = _t(rng.randn(B, N, D).astype(np.float32), dev)
    go = _t(rng.randn(B, N, D).astype(np.float32), dev)
    dq, dgk, dw = t_attn.attn_g_bwd(q_pos, q_proj, g, params, K, go, bf)
    dq2, dgk2, dw2 = t_attn.attn_g_bwd(q_pos, q_proj, g, params, K, go, bf)
    rq, rg, rw = t_attn.attn_g_bwd_plain(q_pos, q_proj, g, params, K, go, bf)
    fq = t_attn.attn_g_bwd(q_pos, q_proj, g, params, K, go)[0]
    torch.cuda.synchronize()
    _bf16_grad_close(dq, rq, 'q_proj')
    _bf16_grad_close(dgk, rg, 'dg')
    assert K == 1 or _rel_l2(fq, rq) > 5e-3  # K 1: d(q_proj) is zero in truth.
    assert torch.equal(dgk[:, K:], rg[:, K:]) and torch.equal(dgk[..., E:], rg[..., E:])
    assert torch.equal(dq, dq2) and torch.equal(dgk, dgk2)
    assert set(dw) == set(rw)
    for name in rw:
        _bf16_grad_close(dw[name], rw[name], name)
        assert torch.equal(dw[name], dw2[name]), name
        if name[1] == 'kernel':  # rounded to bf16 once, after the whole sum.
            assert torch.equal(dw[name], t_attn.round_bf16(dw[name])), name
    for premul in (False, True):
        kv = (torch.cat([feats @ params['to_k']['kernel'],
                         feats @ params['to_v']['kernel']], -1).contiguous()
              if premul else feats)
        args = (q_pos, q_proj, knn[0], pos2, kv, params, K, premul, go)
        iq, ikv, iw = t_attn.attn_bwd(*args, bf)
        iq2, ikv2, iw2 = t_attn.attn_bwd(*args, bf)
        pq, pkv, pw = t_attn.attn_bwd_plain(*args, bf)
        torch.cuda.synchronize()
        _bf16_grad_close(iq, pq, 'q_proj')
        _bf16_grad_close(ikv, pkv, 'kv')
        assert torch.equal(ikv, t_attn.round_bf16(ikv))
        assert torch.equal(iq, iq2) and torch.equal(ikv, ikv2)
        for name in pw:
            _bf16_grad_close(iw[name], pw[name], name)
            assert torch.equal(iw[name], iw2[name]), name
        if not premul:
            assert torch.equal(iq, dq)
            assert all(torch.equal(iw[name], dw[name]) for name in iw)


@pytest.mark.parametrize('case', ['k1', 'k8', 'k32', 'one_key'])
def test_bf16_interp_bwd_and_scatter_kernels_match_plain(dev, case):
    '''o4d_interp_bwd_bf16 and o4d_scatter_bf16 against interp_bwd_plain /
    gather_bwd_plain in bf16 (rows rounded before the per-key sums, the sums
    after them; every result a bf16 value), twice for the same bits; k 1, 8
    and 32, and every entry on one key (about 190 summing chunks per
    example); the f32 kernels outside the gate; the counters count the bf16
    names.'''
    from occlusions4d_torch.ops import _build
    bf = torch.bfloat16
    K = {'k1': 1, 'k8': 8, 'k32': 32, 'one_key': 6}[case]
    rng = np.random.RandomState(90 + K)
    B, N, M, E, KE = 2, 2003, 97, 40, min(K + 2, 32)
    q_pos = _t(rng.rand(B, N, 3).astype(np.float32), dev)
    pos2 = _t(rng.rand(B, M, 3).astype(np.float32), dev)
    ki, kd = t_attn.knn_extract(q_pos, pos2, KE)
    if case == 'one_key':
        ki = torch.full_like(ki, 5)
    g = _t(rng.randn(B, N, E).astype(np.float32), dev)
    dg = _t(rng.randn(B, KE, N, E + 3).astype(np.float32), dev)
    _build.reset_launch_counts()
    i1, i2 = (t_attn.interp_bwd(ki, kd, g, M, K, 1e-4, bf) for _ in range(2))
    s1, s2 = (t_attn.gather_bwd(ki, dg, M, K, bf) for _ in range(2))
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    assert {n: counts[n] for n in ('interp_bwd_bf16', 'scatter_bf16', 'interp_bwd',
                                   'scatter')} == dict(interp_bwd_bf16=2, scatter_bf16=2,
                                                       interp_bwd=0, scatter=0)
    for out, out2, ref, f32 in (
            (i1, i2, t_attn.interp_bwd_plain(ki, kd, g, M, K, 1e-4, bf),
             t_attn.interp_bwd(ki, kd, g, M, K, 1e-4)),
            (s1, s2, t_attn.gather_bwd_plain(ki, dg, M, K, bf),
             t_attn.gather_bwd(ki, dg, M, K))):
        _bf16_grad_close(out, ref, gate=1e-3)
        assert _rel_l2(f32, ref) > 1e-3
        assert torch.equal(out, out2) and torch.equal(out, t_attn.round_bf16(out))
    if case == 'one_key':
        assert not s1[:, :5].any() and not s1[:, 6:].any()


def test_bf16_decoder_backward_launches_bf16_kernels_and_matches_cpu(dev):
    '''fused_field_apply(compute_dtype=bf16) with gradients on both routes
    launches the bf16 backward kernels and no f32 attention, interpolation
    or scatter backward (the shared route's interpolation rows go through
    the f32 o4d_interp_g_bwd, as the TPU's), agrees with its CPU run (plain
    bf16 versions, f32 backbone) within relative L2 1e-2 (the card runs the
    backbone in TF32, forward and backward), and leaves the global matmul
    precision as it found it.'''
    import copy
    from occlusions4d_torch.models.fused import SHARED_GATHER_MIN_M, fused_field_apply
    from occlusions4d_torch.ops import _build
    dec = _small_decoder(dev)
    rng = np.random.RandomState(13)
    q = _t(rng.rand(1, 301, 4).astype(np.float32), dev)
    fg = _t(rng.rand(1, 16).astype(np.float32), dev)
    before = torch.get_float32_matmul_precision()
    f32_names = ('attn_bwd', 'attn_g_bwd', 'interp_bwd', 'scatter', 'attn', 'attn_g')
    for M, shared in ((SHARED_GATHER_MIN_M - 1, False), (SHARED_GATHER_MIN_M + 77, True)):
        abstract = _t(rng.rand(1, M, 3 + 16).astype(np.float32), dev)

        def grads(d, a, qq, f):
            d.zero_grad()
            a = a.clone().requires_grad_(True)
            out, _ = fused_field_apply(d, qq, a, f, compute_dtype=torch.bfloat16)
            out.square().sum().backward()
            return torch.cat([a.grad.ravel()] + [p.grad.ravel() for p in d.parameters()])
        _build.reset_launch_counts()
        got = grads(dec, abstract, q, fg)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        ref = grads(copy.deepcopy(dec).cpu(), abstract.cpu(), q.cpu(), fg.cpu())
        want = dict(attn_g_bwd_bf16=2, scatter_bf16=1, interp_g_bwd=1, attn_bwd_bf16=0,
                    interp_bwd_bf16=0) if shared else \
            dict(attn_g_bwd_bf16=0, scatter_bf16=0, interp_g_bwd=0, attn_bwd_bf16=2,
                 interp_bwd_bf16=1)
        want.update({k: 0 for k in f32_names})
        assert {k: counts[k] for k in want} == want
        assert _rel_l2(got.cpu(), ref) <= 1e-2, _rel_l2(got.cpu(), ref)
        assert torch.get_float32_matmul_precision() == before


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize('K', [8, 16, 32])
@pytest.mark.parametrize('D,E', [(36, 36), (72, 72), (144, 144), (288, 288), (36, 288),
                                 (144, 40), (4, 20)],
                         ids=['d36_e36', 'd72_e72', 'd144_e144', 'd288_e288', 'd36_e288',
                              'd144_e40', 'd4_e20'])
def test_bf16_sattn_kernels_match_plain(dev, K, D, E):
    '''o4d_sattn_bf16 and o4d_sattn_bwd_bf16 (mixed_precision) against
    their plain bf16 versions at odd N, B 2: the forward within relative L2
    2e-4, each gradient within 5e-3 (the logits' bias, zero in truth, atol
    1e-4 x max(1, max|plain|)), as chip_smoke.py holds them; the backward
    twice with the same bits, dgf and the weight kernels' gradients bf16
    values; the f32 kernels fail the same gates.'''
    BF = torch.bfloat16
    rng = np.random.RandomState(80 + K + D + E)
    B, N = 2, 203
    q, gf, rel, params = _sattn_case(rng, dev, B, N, K, D, E)
    gf = t_attn.round_bf16(gf)
    go = _t(rng.randn(B, N, D).astype(np.float32), dev)
    _build = importlib.import_module('occlusions4d_torch.ops._build')
    _build.reset_launch_counts()
    with torch.no_grad():
        out = t_sattn.fused_gathered_attention(q, gf, rel, params, K, compute_dtype=BF)
        ref = t_sattn.sattn_plain(q, gf, rel, params, BF)
        out32 = t_sattn.fused_gathered_attention(q, gf, rel, params, K)
    assert _rel(out, ref) <= 2e-4 < _rel(out32, ref)
    dq, dgf, dw = t_sattn.sattn_bwd(q, gf, rel, params, K, go, BF)
    dq2, dgf2, dw2 = t_sattn.sattn_bwd(q, gf, rel, params, K, go, BF)
    counts = _build.launch_counts()
    assert (counts['sattn_bf16'], counts['sattn_bwd_bf16'], counts['sattn']) == (1, 2, 1)
    rq, rgf, rw = t_sattn.sattn_bwd_plain(q, gf, rel, params, go, BF)
    fq, fgf, fw = t_sattn.sattn_bwd(q, gf, rel, params, K, go)
    torch.cuda.synchronize()
    worst_f32 = max(_rel(fq, rq), _rel(fgf, rgf))
    for a, b in ((dq, rq), (dgf, rgf)):
        assert _rel(a, b) <= 5e-3
    for name in rw:
        if name == ('attn_mlp_2', 'bias'):
            assert float((dw[name] - rw[name]).abs().max()) <= 1e-4 * max(
                1.0, float(rw[name].abs().max()))
            continue
        assert _rel(dw[name], rw[name]) <= 5e-3, name
        worst_f32 = max(worst_f32, _rel(fw[name], rw[name]))
        if name[1] == 'kernel':
            assert torch.equal(dw[name], t_attn.round_bf16(dw[name])), name
        assert torch.equal(dw[name], dw2[name]), name
    assert worst_f32 > 5e-3
    assert torch.equal(dgf, t_attn.round_bf16(dgf))
    assert torch.equal(dq, dq2) and torch.equal(dgf, dgf2)


def test_bf16_self_attention_module_launches_bf16_kernels(dev):
    '''A bf16 VectorAttention(fused='on') on the card launches the bf16
    gather, sattn_bf16 and, in the backward, sattn_bwd_bf16 and the bf16
    scatter once each (no f32 self-attention kernel), and agrees with the
    same module on the CPU (plain bf16 versions): the output within relative
    L2 1e-2, each gradient within 3e-2 (bf16 products summed in another
    order on each side, the JAX package's own bf16 gate).'''
    from occlusions4d_torch.models import VectorAttention
    from occlusions4d_torch.ops import _build
    torch.manual_seed(5)
    rng = np.random.RandomState(6)
    att = VectorAttention(24, num_neighbors=16, fused='on', dtype=torch.bfloat16)
    x = rng.randn(2, 301, 24).astype(np.float32)
    pos = rng.rand(2, 301, 3).astype(np.float32)
    res = {}
    for where in ('cuda', 'cpu'):
        m = att.to(where)
        xx = torch.tensor(x, device=where).requires_grad_(True)
        _build.reset_launch_counts()
        y = m(xx, torch.tensor(pos, device=where))
        grads = torch.autograd.grad((y.float().sin() * 3).sum(), [xx] + list(m.parameters()))
        res[where] = (y.detach().float().cpu(), [g.float().cpu() for g in grads],
                      _build.launch_counts())
    want = dict(gather_bf16=1, scatter_bf16=1, sattn_bf16=1, sattn_bwd_bf16=1, gather=0,
                scatter=0, sattn=0, sattn_bwd=0)
    assert {k: res['cuda'][2][k] for k in want} == want
    assert _rel(res['cuda'][0], res['cpu'][0]) <= 1e-2
    names = ['x'] + [n for n, _ in att.named_parameters()]
    for n, a, b in zip(names, res['cuda'][1], res['cpu'][1]):
        if n != 'attn_mlp.2.bias':   # zero in truth: rounding noise on both sides.
            assert _rel(a, b) <= 3e-2, n


@pytest.mark.parametrize('overlap', ['true', 'false'])
def test_eval_driver_greater_anchor_on_card(dev, tmp_path, overlap):
    '''The eval driver (test_driver.main) on the committed GREATER anchor on
    the card: its scene regenerated from gen.json, the committed eval_argv
    over the first 3 steps with --save_gt; every per-frame metric within
    max(0.02, 3%) of the committed metrics.json, the index route's kernels
    and the labels' nn1_direct (on the post worker thread with
    --eval_overlap true) launched, and the pipelined and serial loops give
    the same metrics bit for bit (the serial case compares its run with a
    pipelined one).'''
    import anchor_recipe
    from occlusions4d_torch.config import test_args
    from occlusions4d_torch.evaluate import test_driver
    from occlusions4d_torch.ops import _build
    data = anchor_recipe.make_scene('greater', tmp_path)

    def run(ov, name):
        argv, committed = anchor_recipe.eval_argv(
            'greater', data, tmp_path / name / 'anchor',
            ('--save_gt', 'true', '--eval_overlap', ov), steps=3)
        _build.reset_launch_counts()
        summary = test_driver.main(test_args(argv), device='cuda')
        torch.cuda.synchronize()
        return summary, committed, _build.launch_counts()

    summary, committed, counts = run(overlap, 'run')
    assert len(summary['per_frame']) == 3
    for got, ref in zip(summary['per_frame'], committed['per_frame']):
        for k, rv in ref.items():
            assert abs(got[k] - rv) <= max(0.02, 0.03 * abs(rv)), (k, got[k], rv)
    for k in ('fps', 'knn_brute', 'interp', 'attn', 'nn1_direct'):
        assert counts[k] > 0, (k, counts)
    if overlap == 'false':
        other, _, _ = run('true', 'other')
        assert other['per_frame'] == summary['per_frame']


def test_train_driver_on_card(dev, tmp_path):
    '''The train driver (train.main) on the card at tiny widths: 2 epochs of
    train and val_aug over a synthetic GREATER dataset, model_0 / model_1 /
    checkpoint.pkl written, the train step's kernels launched; a run resumed
    from model_0 gives epoch 1's logged losses and the final parameters of
    the unbroken run (rel 1e-4, as chip_smoke.py's train_driver gate); its
    checkpoint read by python -m occlusions4d_torch.evaluate.'''
    import glob
    import os
    import subprocess
    import sys
    from occlusions4d_torch import train as t_train
    from occlusions4d_torch.config import train_args
    from occlusions4d_torch.data import synthetic
    from occlusions4d_torch.ops import _build
    data = str(tmp_path / 'data')
    synthetic.make_greater_dataset(data, num_scenes=2, num_views=2, num_frames=14,
                                   image_size=28, stages=('train', 'val', 'test'))
    argv = ['--n_points', '256', '--n_data_rnd', '512', '--video_len', '4', '--frame_skip',
            '2', '--pt_feat_dim', '8', '--up_down_blocks', '2', '--pt_num_neighbors', '8',
            '--down_neighbors', '6', '--global_size', '16', '--num_cr_local_feats', '4',
            '--implicit_mlp_blocks', '3', '--cross_attn_layers', '2', '--cross_attn_neighbors',
            '6', '--num_cr_solid', '48', '--color_mode', 'rgb_nosigmoid', '--color_lw', '1.0',
            '--tracking_lw', '1.0', '--batch_size', '2', '--num_epochs', '2', '--seed', '5',
            '--num_workers', '2', '--use_data_frac', '0.02', '--data_path', data,
            '--name', 'card', '--checkpoint_root', str(tmp_path / 'ck'),
            '--log_root', str(tmp_path / 'logs')]
    _build.reset_launch_counts()
    full = t_train.main(train_args(argv))
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    for k in ('knn_brute', 'fps', 'interp', 'attn', 'attn_bwd', 'interp_bwd'):
        assert counts[k] > 0, (k, counts)
    out = full.cfg.output_path
    assert sorted(os.listdir(out)) == ['checkpoint.pkl', 'model_0.pkl', 'model_1.pkl']
    cfg = train_args(argv + ['--resume', os.path.join(out, 'model_0.pkl'),
                             '--output_path', str(tmp_path / 'resumed')])
    resumed = t_train.main(cfg)
    rows = [{r['epoch']: r for r in t.logger.scalar_history} for t in (full, resumed)]
    for key in ('train/total_loss', 'val_aug/total_loss'):
        assert abs(rows[1][1][key] - rows[0][1][key]) <= 1e-4 * abs(rows[0][1][key]), key
    for a, b in zip(full.optimizer.params, resumed.optimizer.params):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6)
    res = subprocess.run(
        [sys.executable, '-m', 'occlusions4d_torch.evaluate', '--resume', out,
         '--data_path', data, '--num_workers', '0', '--use_data_frac', '0.02',
         '--num_sample', '4096', '--implicit_batch_size', '2048', '--save_metrics', 'true',
         '--log_path', str(tmp_path / 'eval' / 'run')],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert glob.glob(str(tmp_path / 'eval' / 'test_*' / 'metrics.json'))


def _gv1_batch(dev, B, T, N=14336, M=28672, seed=3):
    rng = np.random.RandomState(seed)
    tgt = np.zeros((B, T, M, 9), np.float32)
    tgt[..., :3] = rng.rand(B, T, M, 3) * 10 - 5
    tgt[..., 2] = np.abs(tgt[..., 2])
    tgt[..., 5:8] = rng.rand(B, T, M, 3)
    batch = dict(pcl_input=(rng.rand(B, N, 8) * 2 - 1).astype(np.float32),
                 pcl_target=tgt, pcl_target_valid=np.ones((B, T, M), bool),
                 valo_ids=np.tile(np.arange(32, dtype=np.int32), (B, 1)),
                 num_valo_ids=np.full((B,), 8, np.int32))
    return {k: _t(v, dev) for k, v in batch.items()}


def test_module_path_train_step_on_card(dev):
    '''The decoder's module path (--fused_decoder off, each frame recomputed
    in the backward) at gv1 widths on the card, batch 1, 2 frames: from the
    fused path's initial state and draws, its step-0 loss within 1e-4
    relative of the fused step's (the fused kernels' 3xTF32 products are the
    only difference), finite gradients and parameters; its decoder runs the
    kNN kernel and no fused decoder kernel.'''
    from occlusions4d_torch.config import TrainConfig
    from occlusions4d_torch.ops import _build
    from occlusions4d_torch.train import Trainer
    kw = dict(n_points=14336, pt_feat_dim=36, up_down_blocks=3, transition_factor=3,
              pt_num_neighbors=16, down_neighbors=12, global_size=128, implicit_mlp_blocks=6,
              cross_attn_layers=2, cross_attn_neighbors=14, cr_attn_type='cc',
              color_mode='rgb_nosigmoid', cr_cube_bounds=5.0, min_z=-1.0,
              num_cr_local_feats=8, color_lw=1.0, density_lw=1.0, num_cr_solid=7168,
              air_sampling_ratio=1.5, past_frames=2, future_frames=0, batch_size=1)
    batch = _gv1_batch(dev, 1, 2)
    losses, counts = {}, {}
    for mode in ('auto', 'off'):
        tr = Trainer(TrainConfig(**kw, fused_decoder=mode), 'greater', 'cuda')
        tr.init_state(seed=0)
        assert tr.pipeline.fused_decoder == (mode == 'auto') and tr.pipeline.remat
        _build.reset_launch_counts()
        m = tr.step(batch)
        torch.cuda.synchronize()
        counts[mode] = _build.launch_counts()
        assert bool(m['grads_finite']) and bool(m['params_finite'])
        losses[mode] = float(m['total_loss'])
        del tr
        torch.cuda.empty_cache()
    assert abs(losses['off'] - losses['auto']) <= 1e-4 * abs(losses['auto']), losses
    assert counts['auto']['attn'] > 0 and counts['auto']['attn_bwd'] > 0
    assert counts['off']['attn'] == counts['off']['attn_bwd'] == counts['off']['interp'] == 0
    assert counts['off']['knn_brute'] > counts['auto']['knn_brute'] > 0


def test_store_activations_engine_on_card(dev):
    '''InferenceEngine(store_activations=True) on the committed GREATER
    anchor on the card: outputs bit-equal to the run without the flag, the
    (N, d_hidden) float16 activations in query order, within 2e-3 and one
    float16 step of the CPU engine's (plain versions) from the same encoding.'''
    import os
    from occlusions4d_torch.evaluate.inference import InferenceEngine, load_models
    from occlusions4d_torch.ops import blind_points_numpy
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'assets', 'anchor')
    card, cpu = load_models(path, device='cuda'), load_models(path, device='cpu')
    c = card['train_config']
    q = blind_points_numpy(16384, c.min_z, c.cr_cube_bounds, 0, 'greater', c.cube_mode,
                           'grid')
    pcl = (np.random.RandomState(5).rand(card['encoder_args']['n_input'], 8) * 2
           - 1).astype(np.float32)
    engines = [InferenceEngine(L, c.color_mode, False, 13, implicit_batch_size=4096,
                               store_activations=sa)
               for L, sa in ((card, False), (card, True), (cpu, True))]
    ab, fg = engines[0].encode(pcl)
    out = engines[0].decode_all(q, ab, fg)
    out_sa, pen = engines[1].decode_all(q, ab, fg)
    _, pen_cpu = engines[2].decode_all(q, ab.cpu(), fg.cpu())
    _, part = engines[1].decode_all(q[5000:6000], ab, fg)
    assert np.array_equal(out, out_sa) and np.array_equal(part, pen[5000:6000])
    assert pen.dtype == np.float16 and pen.shape == (len(q), card['decoder_args']['d_hidden'])
    np.testing.assert_allclose(pen.astype(np.float32), pen_cpu.astype(np.float32),
                               atol=2e-3, rtol=2.0 ** -10)
