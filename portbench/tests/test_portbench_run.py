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


class _HostClock:
    """``clock.LayerClock`` on the host's clock, for a traced run on the CPU."""

    def __init__(self):
        self.pairs, self.open, self.handles = {}, {}, []

    def start(self, layer):
        self.open[layer] = time.perf_counter()

    def stop(self, layer):
        self.pairs.setdefault(layer, []).append((self.open.pop(layer), time.perf_counter()))

    def ms(self, layer):
        return 1e3 * sum(b - a for a, b in self.pairs.get(layer, ()))

    def hook_forward(self, module, layer='forward'):
        self.handles += [module.register_forward_pre_hook(lambda *_: self.start(layer)),
                         module.register_forward_hook(lambda *_: self.stop(layer))]

    def detach(self):
        for h in self.handles:
            h.remove()
        self.handles = []


@pytest.mark.parametrize('name', ['stage1_train_b8', 'stage1_test_b1'])
def test_a_traced_run_reads_its_layers_from_the_untraced_window(monkeypatch, name):
    from portbench import clock
    made = []
    monkeypatch.setattr(clock, 'LayerClock', lambda: made.append(_HostClock()) or made[-1])
    cell = tiny_cell(name)
    cell.traffic = dict(cell.traffic, trace_seconds=0.5)
    asked, make = [], core.driver

    def driver(*a, **k):
        drv = make(*a, **k)
        window = drv.window
        drv.window = lambda seconds, clock=None: asked.append((seconds, clock)) or window(seconds, clock)
        return drv

    monkeypatch.setattr(core, 'driver', driver)
    _, setup_s, obs, readings = core.measure(cell, 2 ** 31 + 98, 1.0, True, 'cpu',
                                             time.perf_counter())
    out = core.result(cell, setup_s, obs, readings[0], True, 'cpu')
    assert out['correct'], out['checks']
    (c,) = made
    assert not c.handles and obs['layer_ms']['forward'] > 0
    # every forward of the untraced window was timed, none of the traced one
    assert len(c.pairs['forward']) == obs['steps'] > 0 and obs['trace']['steps'] > 0
    assert obs['attempted'] == obs['steps'] + obs['trace']['steps']
    assert asked == [(1.0, c), (0.5, None)] and obs['window_s'] >= 1.0
    metrics = out['metrics']
    assert set(metrics) <= {m['name'] for m in cell.per_layer}
    forward = [k for k in metrics if k.startswith('forward_ms.')]
    assert forward and metrics[forward[0]]['value'] == pytest.approx(obs['layer_ms']['forward'] / obs['steps'])
    assert out['breakdown'] and out['device']['window_s'] == obs['trace']['window_s']


def test_the_command_prints_no_result_where_the_result_loaded_jax(monkeypatch, capsys):
    """A module of JAX that the readers or the reference load after the window
    still keeps the result from being printed."""
    import torch
    from portbench import run
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
