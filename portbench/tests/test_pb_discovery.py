'''Discovery by name: every cell's units are files, and a new cell is new
files and entries, found without an edit.'''

import json
import os
import shutil

from portbench import registry


def test_every_cell_finds_its_files():
    bench = registry.benchmark()
    readers = {m['name'] for m in bench['per_layer']}
    for cell in bench['workloads']:
        cfg = registry.config(cell['config'])
        mix = registry.mix(cell['traffic'])
        assert registry.driver(mix['driver']).run
        assert registry.limits(cell['name'])
        assert registry.work(cell['config'])
        assert cfg['precision'] in registry.peaks()['flops_per_s']
        reported = registry.per_layer_for(bench, cell['name'])
        assert reported and {m['name'] for m in reported} <= readers
        e2e = {m['name'] for m in registry.end_to_end_for(bench, cell['name'])}
        assert 'setup_s' in e2e and len(e2e) >= 2
    for name in readers:
        assert callable(registry.metric_reader(name))


def test_per_layer_metrics_split_by_cell_kind():
    bench = registry.benchmark()
    train = {m['name'] for m in registry.per_layer_for(bench, 'gv1.train')}
    scene = {m['name'] for m in registry.per_layer_for(bench, 'gv1.scene')}
    assert train == {'idle_pct.train', 'mfu.train', 'attn_bwd_roofline',
                     'decoder_bwd_ms.train', 'sampler_ms.train'}
    assert scene == {'idle_pct.scene', 'mfu.scene', 'attn_roofline', 'encode_ms.scene',
                     'decode_ms.scene'}


def test_a_new_cell_is_new_files_only(tmp_path):
    '''A dummy configuration, mix, metric, limits and work module added to a
    temporary copy as files and entries: the registry finds each.'''
    root = tmp_path / 'checkout'
    here = root / 'portbench'
    shutil.copytree(registry.HERE, here, ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(registry.ROOT, 'BENCHMARK.json'), root / 'BENCHMARK.json')
    cfg = json.loads((here / 'configs' / 'gv1.json').read_text())
    cfg['batch_size'] = 1
    (here / 'configs' / 'dummy.json').write_text(json.dumps(cfg))
    (here / 'mixes' / 'dummy_mix.json').write_text(json.dumps(
        dict(driver='train', pool=2, target_factor=2, first_steps=2, trace_steps=1)))
    (here / 'metrics' / 'dummy_metric.py').write_text('def read(data):\n    return 42.0\n')
    (here / 'limits' / 'dummy.dummy_mix.json').write_text(json.dumps(dict(loss_gap=1e-4)))
    (here / 'work' / 'dummy.py').write_text('from portbench.work._field import '
                                            'train_step_flops  # noqa: F401\n')
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append(dict(name='dummy', source='a test', file='portbench/configs/dummy.json',
                                 reduced=['batch_size'], why='a test'))
    bench['workloads'].append(dict(name='dummy.dummy_mix', config='dummy', traffic='dummy_mix',
                                   chips=1, why='a test'))
    bench['per_layer'].append(dict(name='dummy_metric', unit='%', better='higher',
                                   source='device_trace', layer='Device', moves='step_ms',
                                   workloads=['dummy.dummy_mix']))
    step = next(m for m in bench['end_to_end'] if m['name'] == 'step_ms')
    step['workloads'].append('dummy.dummy_mix')
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))

    found = registry.benchmark(str(root))
    cell = registry.cell(found, 'dummy.dummy_mix')
    assert registry.config(cell['config'], str(here))['batch_size'] == 1
    assert registry.mix(cell['traffic'], str(here))['driver'] == 'train'
    assert registry.limits(cell['name'], str(here)) == dict(loss_gap=1e-4)
    assert registry.work(cell['config'], str(here)).train_step_flops(cfg) > 0
    names = [m['name'] for m in registry.per_layer_for(found, cell['name'])]
    assert names == ['dummy_metric']
    assert registry.metric_reader('dummy_metric', str(here))({}) == 42.0
    assert {m['name'] for m in registry.end_to_end_for(found, cell['name'])} == {
        'step_ms', 'peak_mem_gib', 'setup_s'}
