"""BENCHMARK.json against the benchmark's contract, the files it names, and
the scan of what the harness imports."""

import ast
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'dualsuperreslearningforsemseg_tpu'}
PORT = 'dualsuperreslearningforsemseg_tpu_torch'


def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def test_keys_names_and_units():
    b = bench()
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs', 'workloads', 'end_to_end',
                      'per_layer'}
    assert b['paths'] == ['portbench'] and 1 <= len(b['command']) <= 32
    assert isinstance(b['run_seconds'], int) and 1 <= b['run_seconds'] <= 51
    metrics = b['end_to_end'] + b['per_layer']
    for group in (b['configs'], b['workloads'], metrics):
        names = [x['name'] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in metrics:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher'), m
        extra = set(m) - {'name', 'unit', 'better', 'bound', 'source', 'layer', 'moves', 'workloads'}
        assert not extra, m
    for m in b['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25 and m['source'] in ('host_clock', 'device_trace')
    for w in b['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'} and w['chips'] == 1
        assert NAME.match(w['config']) and NAME.match(w['traffic']) and len(w['why']) <= 200
    assert len({(w['config'], w['traffic']) for w in b['workloads']}) == len(b['workloads'])


def test_every_cell_finds_its_files():
    b = bench()
    configs = {c['name']: c for c in b['configs']}
    for c in b['configs']:
        with open(os.path.join(ROOT, c['file'])) as f:
            data = json.load(f)
        assert data['name'] == c['name'] and data['reduced'] == c['reduced'] == []
    for w in b['workloads']:
        assert w['config'] in configs
        with open(os.path.join(PB, 'workloads', w['name'] + '.json')) as f:
            spec = json.load(f)
        assert (spec['config'], spec['traffic']) == (w['config'], w['traffic'])
        assert os.path.isfile(os.path.join(PB, 'traffic', w['traffic'] + '.json'))
        assert spec['limits']
    for m in b['per_layer']:
        assert os.path.isfile(os.path.join(PB, 'layer_metrics', m['name'] + '.py'))


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    from portbench import core
    b = bench()
    layers = {}
    for m in b['per_layer']:
        e2e = next(x for x in b['end_to_end'] if x['name'] == m['moves'])
        for w in m['workloads']:
            assert w in e2e.get('workloads', [w]), (m['name'], w)
        layers.setdefault(m['layer'].lower(), m['layer'])
    for w in b['workloads']:
        cell = core.Cell(w['name'])
        reported = {m['name'] for m in cell.end_to_end}
        assert 'setup_s' in reported and len(reported) >= 2 and cell.per_layer


def test_a_full_check_fits_with_24_cells():
    rs = bench()['run_seconds']
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, 'attr', '') == 'import_module':
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def _sources(sub=''):
    for d, _, files in os.walk(os.path.join(PB, sub)):
        if os.path.basename(d) in ('tests', '__pycache__'):
            continue
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)


@pytest.mark.parametrize('sub', ['', 'reference'])
def test_no_jax_and_a_reference_free_of_the_program(sub):
    """Top-level names compared whole: the program's name begins with the
    JAX package's."""
    banned = FORBIDDEN | ({PORT} if sub else set())
    for path in _sources(sub):
        tops = {m.split('.')[0] for m in _imports(path)}
        assert not tops & banned, (path, tops & banned)
        with open(path) as f:
            text = f.read()
        for word in ('bench.py', 'BENCH_', 'chip_smoke', 'MULTICHIP'):
            assert word not in text, (path, word)
    assert not any(PORT in (open(p).read()) for p in _sources('reference'))


def test_the_drivers_reach_the_program_by_its_own_name():
    from portbench.drivers.common import PACKAGE
    assert PACKAGE == PORT and PACKAGE.split('.')[0] not in FORBIDDEN
