'''
Discovery by name: every unit of the benchmark sits in a file of its own,
found from the names in BENCHMARK.json, so that a new configuration, mix,
metric or cell is a new file and an entry, never an edit.

  configs/<config>.json    the TrainConfig fields of a configuration, with
                           its source, reduced keys, assumed sizes and
                           data_kind;
  mixes/<traffic>.json     a traffic mix: the loop module that runs it
                           (drivers/<driver>.py) and its parameters;
  metrics/<metric>.py      a per-layer metric: read(data) -> number or None;
  work/<config>.py         the operations and bytes of the configuration's
                           networks and kernels;
  limits/<cell>.json       the limit of each number the cell's check compares.
'''

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts):
    path = os.path.join(*parts)
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _json(root, 'BENCHMARK.json')


def cell(bench, name):
    for w in bench['workloads']:
        if w['name'] == name:
            return w
    raise KeyError(f'no workload {name!r} in BENCHMARK.json (cells: '
                   f'{", ".join(w["name"] for w in bench["workloads"])})')


def config(name, here=HERE):
    return _json(here, 'configs', f'{name}.json')


def mix(name, here=HERE):
    return _json(here, 'mixes', f'{name}.json')


def limits(cell_name, here=HERE):
    return _json(here, 'limits', f'{cell_name}.json')


def peaks(here=HERE):
    return _json(here, 'peaks.json')


def _module_at(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name):
    return importlib.import_module(f'portbench.drivers.{name}')


def work(config_name, here=HERE):
    return _module_at(os.path.join(here, 'work', f'{config_name}.py'),
                      f'portbench.work.{config_name}')


def metric_reader(name, here=HERE):
    return _module_at(os.path.join(here, 'metrics', f'{name}.py'),
                      f'portbench.metrics.{name}').read


def end_to_end_for(bench, cell_name):
    '''The end-to-end metrics a cell reports.'''
    return [m for m in bench['end_to_end']
            if 'workloads' not in m or cell_name in m['workloads']]


def per_layer_for(bench, cell_name):
    '''The per-layer metrics a cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports.'''
    e2e = {m['name'] for m in end_to_end_for(bench, cell_name)}
    return [m for m in bench['per_layer']
            if (cell_name in m['workloads'] if 'workloads' in m else m['moves'] in e2e)]
