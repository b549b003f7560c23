'''
The train step's observability held against the JAX package on the CPU, at
tiny widths, under the fixed samplers of tests/test_torch_train.py (the
Trainer-level cases, --check_numerics and --profile_steps, are
tests/test_torch_observability_trainer.py):
  (a) --fused_decoder off: a 2-step lockstep of the port's module path
      (TrainPipeline(fused_decoder='off'), each frame recomputed in the
      backward) against JAX TrainPipeline(fused_decoder='off', remat=True)
      and make_train_step (tests/test_torch_train.py's tolerances: scalars
      rtol 2e-4 / atol 2e-5, parameter deltas 5e-4 relative L2); remat on
      and off give the same gradients (1e-6);
  (c) --watch_networks: the per-layer gradient and parameter norms against
      JAX make_train_step(watch_networks=True), leaf for leaf through
      from_jax_params's mapping, within 1e-5 relative (and 1e-5 of the
      largest norm, for the rounding-noise gradients of biases the softmax
      ignores and the AdamW moves they cause).
'''

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from occlusions4d_tpu import train as j_train
from occlusions4d_tpu.config import TrainConfig as JTrainConfig
from occlusions4d_tpu.models.encoder import PointEncoder as JEncoder
from occlusions4d_tpu.models.implicit import LocalImplicitField as JField
from occlusions4d_tpu.pipeline import PipelineConfig as JPipelineConfig
from occlusions4d_tpu.pipeline import TrainPipeline as JTrainPipeline
from occlusions4d_tpu.sampler import SamplerConfig as JSamplerConfig
from occlusions4d_torch import train as t_train
from occlusions4d_torch.checkpoint import from_jax_params
from occlusions4d_torch.config import TrainConfig
from occlusions4d_torch.models.encoder import PointEncoder
from occlusions4d_torch.models.implicit import LocalImplicitField
from occlusions4d_torch.pipeline import PipelineConfig, TrainPipeline
from occlusions4d_torch.sampler import SamplerConfig


def _t(a):
    return torch.tensor(np.asarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ----------------------------------------------- fixed-supervision lockstep --

_ENC = dict(n_input=256, n_output=256, d_in=8, d_out=1, d_feat=8, down_blocks=2,
            up_blocks=2, transition_factor=3, pt_num_neighbors=8, pt_norm_type='none',
            down_neighbors=6, abstract_levels=1, skip_connections=False,
            enable_decoder=False, output_featurized=True, output_global_emb=True,
            global_dim=16, fps_random_start=False)
_DEC = dict(d_in=4, d_hidden=48, d_out=5, d_latent=48, n_blocks=3, pos_encoding_freqs=8,
            activation='relu', num_local_features=4, local_mode='attention',
            d_latent_local=32, cross_attn_neighbors=6, cross_attn_layers=2,
            cr_attn_type='cc')
_PCFG = dict(color_mode='rgb_nosigmoid', semantic_classes=13, past_frames=2,
             future_frames=0, density_lw=1.0, color_lw=1.0, segmentation_lw=0.0,
             tracking_lw=1.0)
_OPT = dict(learn_rate=1e-3, num_epochs=20, lr_decay=0.5, gradient_clip=0.2)


def _supervision(T, n_q, seed=3):
    '''Fixed (queries, targets) per frame: mixed solid / air density, some
    colour-unavailable rows, track in {-1, 0, 1}.'''
    rng = np.random.RandomState(seed)
    q = np.concatenate([(rng.rand(T, n_q, 3) * 4.0 - 2.0).astype(np.float32),
                        np.tile(np.arange(T, dtype=np.float32)[:, None, None],
                                (1, n_q, 1))], axis=-1)
    tgt = np.zeros((T, n_q, 6), np.float32)
    tgt[..., 0] = (rng.rand(T, n_q) < 0.5).astype(np.float32)
    rgb = rng.rand(T, n_q, 3).astype(np.float32)
    rgb[rng.rand(T, n_q) < 0.3] = -1.0
    tgt[..., 1:4] = rgb
    tgt[..., 4] = np.where(rng.rand(T, n_q) < 0.25, -1.0,
                           (rng.rand(T, n_q) < 0.5).astype(np.float32))
    tgt[..., 5] = -1.0
    return q, tgt


class _JFixedSampler:
    def __init__(self, queries, targets, n_solid):
        self.q, self.t, self.n_solid = queries, targets, n_solid

    def sample_frame(self, key, tgt, tgt_valid, other, other_valid, valo_ids,
                     num_valo_ids, time_idx):
        t, S = int(time_idx), self.n_solid
        q, tg = jnp.asarray(self.q[t]), jnp.asarray(self.t[t])
        return dict(solid_input=q[:S], air_input=q[S:], solid_target=tg[:S],
                    air_target=tg[S:], solid_sbs=jnp.zeros((6,), jnp.float32),
                    air_sbs=jnp.zeros((4,), jnp.float32), ok=jnp.asarray(True))


class _TFixedSampler(_JFixedSampler):
    def sample_frame(self, gen, tgt, tgt_valid, other, other_valid, valo_ids,
                     num_valo_ids, time_idx):
        B, t, S = tgt.shape[0], int(time_idx), self.n_solid
        q = _t(self.q[t])[None].expand(B, -1, -1)
        tg = _t(self.t[t])[None].expand(B, -1, -1)
        return dict(solid_input=q[:, :S], air_input=q[:, S:], solid_target=tg[:, :S],
                    air_target=tg[:, S:], solid_sbs=torch.zeros((B, 6)),
                    air_sbs=torch.zeros((B, 4)), ok=torch.ones((B,), dtype=torch.bool))


def _batch(pcl):
    return dict(pcl_input=pcl, pcl_target=np.zeros((1, 2, 8, 9), np.float32),
                pcl_target_valid=np.ones((1, 2, 8), bool),
                valo_ids=np.zeros((1, 4), np.int32), num_valo_ids=np.zeros((1,), np.int32))


def _module_path_setup():
    rng = np.random.RandomState(3)
    pcl = (rng.rand(1, 256, 8) * 2.0 - 1.0).astype(np.float32)
    queries, targets = _supervision(2, 96)
    jenc, jdec = JEncoder(**_ENC), JField(**_DEC)
    enc_vars = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(pcl))
    # The decoder's parameters depend on the encoder's output shapes only.
    ab, fg, _ = jax.eval_shape(jenc.apply, enc_vars, jnp.asarray(pcl))
    dec_vars = jax.jit(jdec.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 4)),
                                  jnp.zeros(ab.shape), jnp.zeros(fg.shape))
    jpipe = JTrainPipeline(jenc, jdec, JSamplerConfig(), JPipelineConfig(**_PCFG),
                           remat=True, fused_decoder='off')
    jpipe.sampler = _JFixedSampler(queries, targets, 48)
    tenc, tdec = PointEncoder(**_ENC), LocalImplicitField(**_DEC)
    tenc.load_state_dict(from_jax_params(_np_tree(enc_vars), tenc), strict=True)
    tdec.load_state_dict(from_jax_params(_np_tree(dec_vars), tdec), strict=True)
    tpipe = TrainPipeline(tenc.train(), tdec.train(), SamplerConfig(),
                          PipelineConfig(**_PCFG), fused_decoder='off')
    tpipe.sampler = _TFixedSampler(queries, targets, 48)
    return jpipe, tpipe, dict(encoder=enc_vars, decoder=dec_vars), _batch(pcl)


def _named(tpipe):
    return dict(tpipe.encoder.named_parameters(),
                **{'dec.' + n: p for n, p in tpipe.decoder.named_parameters()})


def _to_torch_layout(tree, tpipe):
    out = dict(from_jax_params(_np_tree(tree['encoder']), tpipe.encoder))
    out.update({'dec.' + k: v for k, v in from_jax_params(
        _np_tree(tree['decoder']), tpipe.decoder).items()})
    return out


def test_module_path_lockstep_and_layer_norms_match_jax():
    '''(a) 2 steps of the module path, and (c) the per-layer norms of the
    first step (JAX's make_train_step(watch_networks=True), both).'''
    jpipe, tpipe, jparams, batch = _module_path_setup()
    assert not tpipe.fused_decoder and not jpipe.fused_decoder
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: _t(v) for k, v in batch.items()}
    tx, _ = j_train.build_optimizer(JTrainConfig(**_OPT, mixed_precision=False), 1000)
    t_params = _named(tpipe)
    state = dict(params=jparams, opt_state=tx.init(jparams), step=jnp.zeros((), jnp.int32))
    jstep = j_train.make_train_step(jpipe, tx, watch_networks=True)
    names = j_train.layer_norm_names(jparams)
    opt = t_train.build_optimizer(TrainConfig(**_OPT), 1000, list(t_params.values()))
    tstep = t_train.make_train_step(tpipe, opt, watch_networks=True)
    init = {n: p.detach().clone() for n, p in t_params.items()}
    for i in range(2):
        state, jm = jstep(state, jbatch, jax.random.PRNGKey(i), True)
        tm = tstep(tbatch, torch.Generator(), want_norms=True)
        for k in ('total_loss', 'loss_dens', 'loss_rgb', 'loss_track', 'grad_norm'):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4, atol=2e-5,
                                       err_msg=f'step {i} {k}')
        assert bool(tm['grads_finite']) and bool(tm['params_finite'])
        ref = _to_torch_layout(jax.tree_util.tree_map(np.asarray, state['params']), tpipe)
        dt = torch.cat([(t_params[n].detach() - init[n]).ravel() for n in t_params])
        dj = torch.cat([(ref[n] - init[n]).ravel() for n in t_params])
        assert float((dt - dj).norm() / dt.norm()) < 5e-4, i
        # (c) The norms, leaf for leaf: JAX's stacked leaves as a params
        # tree, mapped to the torch keys (a norm is a transpose's norm).
        # atol 1e-5 of the largest norm: the gradient of a bias the softmax
        # ignores is rounding noise (about 1e-9) in either package, and
        # AdamW moves such a near-zero bias by its noise's sign.
        assert tm['layer_grad_norms'].shape == (len(t_params),) and len(names) == len(t_params)
        treedef = jax.tree_util.tree_structure(jparams)
        for key in ('layer_grad_norms', 'layer_param_norms'):
            jtree = jax.tree_util.tree_unflatten(treedef, list(np.asarray(jm[key])))
            jref = _to_torch_layout(jtree, tpipe)
            got = dict(zip(t_params, tm[key].numpy()))
            floor = 1e-5 * float(np.max(np.asarray(jm[key])))
            for n in t_params:
                np.testing.assert_allclose(got[n], float(jref[n]), rtol=1e-5, atol=floor,
                                           err_msg=f'step {i} {key} {n}')
    # Off the logging cadence neither computes them.
    assert 'layer_grad_norms' not in tstep(tbatch, torch.Generator(), want_norms=False)


def test_module_path_remat_keeps_the_gradients():
    '''(a) The recompute changes no gradient: remat on and off within 1e-6.'''
    torch.manual_seed(0)
    enc, dec = PointEncoder(**_ENC).train(), LocalImplicitField(**_DEC).train()
    queries, targets = _supervision(2, 96)
    pcl = (np.random.RandomState(3).rand(1, 256, 8) * 2.0 - 1.0).astype(np.float32)
    batch = {k: _t(v) for k, v in _batch(pcl).items()}
    grads = []
    for remat in (True, False):
        tpipe = TrainPipeline(enc, dec, SamplerConfig(), PipelineConfig(**_PCFG),
                              fused_decoder='off', remat=remat)
        tpipe.sampler = _TFixedSampler(queries, targets, 48)
        t_params = _named(tpipe)
        loss, _ = tpipe.loss(batch, torch.Generator())
        grads.append(torch.autograd.grad(loss, list(t_params.values())))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)
