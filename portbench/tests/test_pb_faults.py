'''The check fails the faults a cell can have, planted underneath the timed
path of a whole run (tiny widths, the CPU; the run's look for a card is
what is skipped), and the control: the reference in a lower precision put in
the program's place. Single-card cells have no exchange between cards to
leave out.'''

import pytest
import torch

from portbench import compare, inputs, registry
from portbench.drivers import scene as scene_driver
from portbench.drivers import train as train_driver
from portbench.reference import ops


def check(ctx):
    run = registry.driver(ctx.mix['driver']).run(ctx)
    return compare.checks(run['readings'], ctx.limits)


@pytest.mark.parametrize('cell', ['gv1.train', 'cv1.train'])
def test_a_step_that_leaves_the_state_unchanged_fails(tiny, monkeypatch, cell):
    from occlusions4d_torch import train
    monkeypatch.setattr(train.AdamW, 'update', lambda self, grads, norm, apply: None)
    rows, ok = check(tiny(cell)[1])
    assert not ok
    assert {r['name']: r['value'] for r in rows}['change_gap'] == pytest.approx(1.0)


@pytest.mark.parametrize('cell', ['gv1.train', 'cv1.train'])
def test_half_the_batch_left_out_fails(tiny, monkeypatch, cell):
    from occlusions4d_torch import pipeline
    full = pipeline.per_example_losses

    def half(output, target, cfg, frame_weight=None, group=None):
        keep = output.shape[0] - output.shape[0] // 2
        return full(output[:keep], target[:keep], cfg, frame_weight=frame_weight[:keep],
                    group=group)

    monkeypatch.setattr(pipeline, 'per_example_losses', half)
    _, ok = check(tiny(cell)[1])
    assert not ok


@pytest.mark.parametrize('cell', ['gv1.scene', 'cv1.scene'])
def test_an_answer_altered_where_it_is_produced_fails(tiny, monkeypatch, cell):
    from occlusions4d_torch.evaluate import inference
    squash = inference.squash_eval

    def altered(*args, **kwargs):
        out = squash(*args, **kwargs)
        out[0, 7, 0] += 0.01          # one query's density in each decoded chunk.
        return out

    monkeypatch.setattr(inference, 'squash_eval', altered)
    rows, ok = check(tiny(cell)[1])
    assert not ok
    assert {r['name']: r['value'] for r in rows}['output_gap'] >= 0.009


@pytest.mark.parametrize('cell', ['gv1.train', 'cv1.train'])
def test_the_lower_precision_control_fails_train(tiny, cell):
    '''bf16 products (autocast) stand for the card's TF32 on the CPU.'''
    _, ctx = tiny(cell)
    tr, weights, pool, _ = train_driver.setup(ctx)
    del tr
    ref = train_driver.reference(ctx, weights, pool)
    with torch.autocast('cpu', dtype=torch.bfloat16):
        low = train_driver.reference(ctx, weights, pool)
    _, ok = compare.checks(compare.train_readings(low, ref), ctx.limits)
    assert not ok


@pytest.mark.parametrize('cell', ['gv1.scene', 'cv1.scene'])
def test_the_lower_precision_control_fails_scene(tiny, cell):
    _, ctx = tiny(cell)
    engine, weights, scene = scene_driver.setup(ctx)
    del engine, scene
    ref = scene_driver.ref_scene.SceneReference(ctx.config, weights, 'cpu')
    cfg, mix = ctx.config, ctx.mix
    cloud = inputs.scene_cloud(cfg, cfg['data_kind'], ctx.seed, 0)
    queries = ops.grid_queries(mix['num_sample'], cfg['min_z'], cfg['cr_cube_bounds'], 0,
                               cfg['data_kind'], cfg['cube_mode'])
    abstract, fg = ref.encode(cloud)
    want = ref.decode(queries, abstract, fg)
    with torch.autocast('cpu', dtype=torch.bfloat16):
        l_abs, l_fg = ref.encode(cloud)
        got = ref.decode(queries, l_abs, l_fg).float()
    readings = dict(encoder_gap=max(compare.scaled_gap(l_abs.float(), abstract),
                                    compare.scaled_gap(l_fg.float(), fg)),
                    output_gap=compare.scaled_gap(got, want))
    _, ok = compare.checks(readings, ctx.limits)
    assert not ok
