"""The readers of the program's spans (``layer_metrics/_spans.py`` and the
metrics that go through it): the milliseconds a step on a synthetic ring,
None where the window's records are missing or the program has no ring,
and which cells list them; and a traced run on the CPU reading the host
spans of its untraced window."""

import json
import os
import sys
import time

import pytest

from portbench import core
from dualsuperreslearningforsemseg_tpu_torch.utils import spans

from .conftest import ROOT, tiny_cell

TRAIN = ['augment_dev_ms.train', 'forward_dev_ms.train', 'loss_dev_ms.train',
         'backward_dev_ms.train', 'optimizer_dev_ms.train', 'host_step_ms.train']
EVAL = ['transform_dev_ms.eval', 'transform_host_ms.eval', 'forward_dev_ms.eval',
        'tail_dev_ms.eval']
TEST = ['input_host_ms.test', 'forward_host_ms.test', 'forward_dev_ms.test',
        'readback_host_ms.test']

# Each step of a driver: (span, host ms, device ms or None), in order.
STEPS = {
    'train': [('data.warp', 1.5, 0.5), ('train.step', 40.0, None), ('data.post', 0.25, 0.75),
              ('train.forward', 3.0, 9.0), ('train.loss', 2.0, 1.25), ('losses.fa', 1.75, None),
              ('train.backward', 4.0, 20.0), ('train.optimizer', 0.5, 1.0)],
    'eval': [('data.eval_transform', 2.5, 1.5), ('eval.forward', 1.0, 30.0),
             ('eval.tail', 0.75, 0.25)],
    'test': [('test.input', 0.75, None), ('test.forward', 6.0, 5.5), ('test.readback', 3.25, None)],
}
EXPECTED = {
    'augment_dev_ms.train': 0.5 + 0.75, 'forward_dev_ms.train': 9.0, 'loss_dev_ms.train': 1.25,
    'backward_dev_ms.train': 20.0, 'optimizer_dev_ms.train': 1.0,
    'host_step_ms.train': 1.5 + 40.0, 'fa_host_ms.train': 1.75,
    'transform_dev_ms.eval': 1.5, 'transform_host_ms.eval': 2.5, 'forward_dev_ms.eval': 30.0,
    'tail_dev_ms.eval': 0.25,
    'input_host_ms.test': 0.75, 'forward_host_ms.test': 6.0, 'forward_dev_ms.test': 5.5,
    'readback_host_ms.test': 3.25,
}


class _Event:
    """A CUDA event of the synthetic ring: a time in ms."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def _push(ring, name, t_ms, host_ms, device_ms, profiled):
    seq = ring.next_seq
    ring.next_seq += 1
    i = seq % ring.size
    ring.seqs[i], ring.names[i], ring.parents[i] = seq, name, None
    ring.starts[i], ring.ends[i] = int(t_ms * 1e6), int((t_ms + host_ms) * 1e6)
    ring.profiled[i], ring.timed[i] = profiled, device_ms is not None
    ring.events[i] = None if device_ms is None else (_Event(t_ms), _Event(t_ms + device_ms))


def _ring(driver, setup, window, profiled, size=spans.RING_SIZE):
    """Set-up steps at 100 times the times, the window's steps, then profiled
    steps at 10 times."""
    ring, t = spans.Ring(size), 0.0
    for steps, scale, prof in ((setup, 100.0, False), (window, 1.0, False), (profiled, 10.0, True)):
        for _ in range(steps):
            for name, host, dev in STEPS[driver]:
                _push(ring, name, t, scale * host, None if dev is None else scale * dev, prof)
                t += 200.0
    return ring


def _obs(driver, steps):
    return {'traffic': {'driver': driver}, 'steps': steps}


@pytest.mark.parametrize('driver,names', [('train', TRAIN + ['fa_host_ms.train']),
                                          ('eval', EVAL), ('test', TEST)])
def test_each_reader_reads_its_spans_a_step_over_the_untraced_window(monkeypatch, driver,
                                                                     names):
    monkeypatch.setattr(spans, 'RING', _ring(driver, setup=3, window=5, profiled=2))
    for name in names:
        assert core.layer_reader(name)(_obs(driver, 5)) == pytest.approx(EXPECTED[name]), name


@pytest.mark.parametrize('driver,names', [('train', TRAIN), ('eval', EVAL), ('test', TEST)])
def test_a_reader_reads_none_where_the_window_is_missing(monkeypatch, driver, names):
    per_step = len(STEPS[driver])
    # the ring came round: it holds 4 of the window's 5 steps
    monkeypatch.setattr(spans, 'RING', _ring(driver, 0, 5, 2, size=6 * per_step))
    for name in names:
        assert core.layer_reader(name)(_obs(driver, 5)) is None, name
        assert core.layer_reader(name)(_obs(driver, 0)) is None, name
    # a program without the ring (a tree from before the spans)
    monkeypatch.setattr(spans, 'RING', _ring(driver, 3, 5, 2))
    monkeypatch.setitem(sys.modules, 'dualsuperreslearningforsemseg_tpu_torch.utils.spans', None)
    for name in names:
        assert core.layer_reader(name)(_obs(driver, 5)) is None, name


def test_fa_reads_none_where_the_step_has_no_fa(monkeypatch):
    ring = spans.Ring()
    for k in range(4):
        for name, host, dev in STEPS['train']:
            if name != 'losses.fa':
                _push(ring, name, 100.0 * k, host, dev, False)
    monkeypatch.setattr(spans, 'RING', ring)
    assert core.layer_reader('fa_host_ms.train')(_obs('train', 4)) is None
    assert core.layer_reader('loss_dev_ms.train')(_obs('train', 4)) == pytest.approx(1.25)


def test_the_cells_list_the_span_metrics():
    listed = {name: {m['name'] for m in core.Cell(name).per_layer}
              for name in ('stage1_train_b8', 'stage3_train_b8', 'stage1_eval_b16',
                           'stage1_test_b1')}
    assert set(TRAIN) <= listed['stage1_train_b8']
    assert 'fa_host_ms.train' not in listed['stage1_train_b8']
    assert set(TRAIN) | {'fa_host_ms.train'} <= listed['stage3_train_b8']
    assert set(EVAL) <= listed['stage1_eval_b16'] and set(TEST) <= listed['stage1_test_b1']
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        per_layer = {m['name']: m for m in json.load(f)['per_layer']}
    for name in EXPECTED:
        m = per_layer[name]
        assert (m['unit'], m['better'], m['source']) == ('ms', 'lower', 'program_span'), name


@pytest.mark.parametrize('name,host', [
    ('stage1_test_b1', ['input_host_ms.test', 'forward_host_ms.test', 'readback_host_ms.test']),
    ('stage1_eval_b16', ['transform_host_ms.eval'])])
def test_a_traced_run_on_the_cpu_reads_the_host_spans_of_its_untraced_window(name, host):
    """On the CPU the spans take no device stamps: the device readers read
    None and the host ones a positive time a step."""
    cell = tiny_cell(name)
    cell.traffic = dict(cell.traffic, trace_seconds=0.5)
    _, setup_s, obs, readings = core.measure(cell, 2 ** 31 + 97, 1.0, True, 'cpu',
                                             time.perf_counter())
    out = core.result(cell, setup_s, obs, readings[0], True, 'cpu')
    assert out['correct'], out['checks']
    metrics = out['metrics']
    assert all(metrics[m]['value'] > 0 and metrics[m]['unit'] == 'ms' for m in host), metrics
    assert not any(m.startswith(('forward_dev_ms', 'transform_dev_ms', 'tail_dev_ms'))
                   for m in metrics)
