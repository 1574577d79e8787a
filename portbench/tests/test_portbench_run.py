"""Whole runs at the small size on the CPU: the harness past its look for a
card, sound and with the timed path broken underneath (each fault must
turn ``correct`` false), and traced; the command's refusal without a card
and its refusal of a run that loaded JAX; and, on a card, the TF32 control
at the cells' own size, judged by ``core.result``."""

import json
import os
import subprocess
import sys
import time
import types

import pytest

from portbench import core

from .conftest import ROOT, tiny_cell


def _run(name, fault=None):
    cell = tiny_cell(name)
    _, setup_s, obs, readings = core.measure(cell, 2 ** 31 + 99, 1.0, False, 'cpu',
                                             time.perf_counter(), fault)
    return core.result(cell, setup_s, obs, readings[0], False, 'cpu')


@pytest.mark.parametrize('name', ['stage1_train_b8', 'stage3_train_b8', 'stage1_eval_b16',
                                  'stage1_test_b1'])
def test_a_sound_run_is_correct(name):
    out = _run(name)
    assert out['correct'], out['checks']
    assert out['attempted'] > 0 and out['failed'] == 0
    assert list(out)[-1] == 'checks'
    assert set(out['metrics']) == {m['name'] for m in core.Cell(name).end_to_end}


@pytest.mark.parametrize('name,fault', [
    ('stage1_train_b8', 'half_batch'), ('stage1_train_b8', 'frozen_state'),
    ('stage3_train_b8', 'half_batch'), ('stage3_train_b8', 'frozen_state'),
    ('stage1_eval_b16', 'half_batch'), ('stage1_eval_b16', 'altered_answer'),
    ('stage1_test_b1', 'altered_answer')])
def test_a_broken_timed_path_is_not_correct(name, fault):
    out = _run(name, fault)
    assert not out['correct'], out['checks']


# The host-clock metric of each traced cell, and the spans it sums.
HOST_SPANS = {'stage1_train_b8': ('host_step_ms.train', ('data.warp', 'train.step')),
              'stage1_test_b1': ('forward_host_ms.test', ('test.forward',))}


@pytest.mark.parametrize('name', ['stage1_train_b8', 'stage1_test_b1'])
def test_a_traced_run_reads_its_layers_from_the_untraced_window(monkeypatch, name):
    from portbench.layer_metrics import _spans
    cell = tiny_cell(name)
    cell.traffic = dict(cell.traffic, trace_seconds=0.5)
    asked, make = [], core.driver

    def driver(*a, **k):
        drv = make(*a, **k)
        window = drv.window
        drv.window = lambda seconds: asked.append(seconds) or window(seconds)
        return drv

    monkeypatch.setattr(core, 'driver', driver)
    _, setup_s, obs, readings = core.measure(cell, 2 ** 31 + 98, 1.0, True, 'cpu',
                                             time.perf_counter())
    out = core.result(cell, setup_s, obs, readings[0], True, 'cpu')
    assert out['correct'], out['checks']
    assert asked == [1.0, 0.5] and obs['window_s'] >= 1.0
    assert obs['steps'] > 0 and obs['trace']['steps'] > 0
    assert obs['attempted'] == obs['steps'] + obs['trace']['steps']
    # the spans read are every step of the untraced window's, none of the traced one's
    records = _spans.window(obs)
    opened = [r for r in records if r.name == _spans.MARKERS[cell.traffic['driver']]]
    assert len(opened) == obs['steps'] and not any(r.profiled for r in records)
    metrics = out['metrics']
    assert set(metrics) <= {m['name'] for m in cell.per_layer}
    metric, spans = HOST_SPANS[name]
    summed = sum(r.host_ms for r in records if r.name in spans) / obs['steps']
    assert metrics[metric]['value'] == pytest.approx(summed) and summed > 0
    assert out['breakdown'] and out['device']['window_s'] == obs['trace']['window_s']


def test_the_command_prints_no_result_where_the_result_loaded_jax(monkeypatch, capsys):
    """A module of JAX that the readers or the reference load after the window
    still keeps the result from being printed."""
    import torch
    from portbench import run
    for var in ('DSRL_TPU_MODEL_INPUT_SIZE', 'DSRL_TPU_BACKBONE_LAYERS'):
        monkeypatch.setenv(var, os.environ.get(var, ''))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setattr(core, 'select_device', lambda: None)
    monkeypatch.setattr(core, 'measure', lambda *a, **k: (types.SimpleNamespace(), 1.0,
                                                          {'reference_s': 0.0}, [{'class_gap': 0.0}]))

    def result(*a, **k):
        monkeypatch.setitem(sys.modules, 'flax.linen', types.ModuleType('flax.linen'))
        return {'correct': True, 'checks': {'class_gap': {'value': 0.0, 'limit': 1e-3}}}

    monkeypatch.setattr(core, 'result', result)
    args = ['--workload', 'stage1_test_b1', '--seed', '1', '--seconds', '1', '--trace', '1']
    assert run.main(args) == 3
    captured = capsys.readouterr()
    assert 'flax' in captured.err and '{' not in captured.out


def _command(args, env_extra=None, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if not k.startswith('DSRL_TPU_')}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, '-m', 'portbench.run'] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_the_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _command(['--workload', 'stage1_test_b1', '--seed', str(2 ** 31 + 5), '--seconds', '1',
                  '--trace', '0'], {'CUDA_VISIBLE_DEVICES': ''})
    assert p.returncode != 0 and 'CUDA card' in p.stderr
    assert not any(line.startswith('{') for line in p.stdout.splitlines())


def test_the_command_keeps_the_bytecode_it_compiles_inside_its_checkout():
    """Where the environment writes no bytecode, the command still keeps the
    bytecode of what it imports at a fixed path of the checkout, so that a
    later run does not compile it again."""
    import importlib.util
    saved = sys.pycache_prefix
    sys.pycache_prefix = os.path.join(ROOT, 'build', 'portbench', 'pycache')
    try:
        pyc = importlib.util.cache_from_source(os.path.join(ROOT, 'portbench', 'core.py'))
    finally:
        sys.pycache_prefix = saved
    if os.path.exists(pyc):
        os.remove(pyc)
    p = _command(['--workload', 'no_such_cell', '--seed', '1', '--seconds', '1', '--trace', '0'],
                 {'PYTHONDONTWRITEBYTECODE': '1'})
    assert p.returncode != 0 and 'no_such_cell' in p.stderr
    assert os.path.isfile(pyc)


@pytest.mark.cuda
@pytest.mark.parametrize('name,seconds', [('stage1_train_b8', 1), ('stage3_train_b8', 1),
                                          ('stage1_eval_b16', 10), ('stage1_test_b1', 10)])
def test_the_tf32_control_fails_at_the_cells_size(card, name, seconds):
    """The reference in TF32 in the program's place, at the cell's own size
    (one seed here; the limits were set from three or more)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith('DSRL_TPU_')}
    p = subprocess.run([sys.executable, '-m', 'portbench.calibrate', '--workload', name,
                        '--seeds', str(2 ** 31 + 77), '--seconds', str(seconds), '--control'],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line['correct'] is True, line
    assert line['control_correct'] is False, line
