"""The reader of ``graph_replay_pct.test``: 100 where every frame of the
untraced window replayed its graph (``test.replay``), the share where some
did, None where none did, where the window is missing, and for a program
without the ring; and its entry in ``BENCHMARK.json``."""

import json
import os
import sys

import pytest

from portbench import core
from dualsuperreslearningforsemseg_tpu_torch.utils import spans

from .conftest import ROOT
from .test_portbench_spans import _obs, _push

READ = core.layer_reader('graph_replay_pct.test')
EAGER = [('test.input', 0.75, None), ('test.forward', 6.0, 5.5), ('test.readback', 3.25, None)]
REPLAYED = [('test.input', 0.25, None), ('test.forward', 0.5, 5.0), ('test.replay', 0.25, None),
            ('test.readback', 5.25, None)]


def _ring(steps, size=spans.RING_SIZE):
    """A ring of ``steps`` (each a list of spans) run unprofiled, then two
    profiled replayed frames."""
    ring, t = spans.Ring(size), 0.0
    for step, profiled in [(s, False) for s in steps] + [(REPLAYED, True)] * 2:
        for name, host, dev in step:
            _push(ring, name, t, host, dev, profiled)
            t += 20.0
    return ring


@pytest.mark.parametrize('steps,expected', [
    ([EAGER] * 2 + [REPLAYED] * 5, 100.0),      # the captures' eager frames fall before
    ([REPLAYED] * 3 + [EAGER] + [REPLAYED], 80.0),
])
def test_the_share_of_frames_that_replayed_their_graph(monkeypatch, steps, expected):
    monkeypatch.setattr(spans, 'RING', _ring(steps))
    assert READ(_obs('test', 5)) == pytest.approx(expected)


def test_none_without_replays_a_window_or_the_ring(monkeypatch):
    monkeypatch.setattr(spans, 'RING', _ring([EAGER] * 5))
    assert READ(_obs('test', 5)) is None
    monkeypatch.setattr(spans, 'RING', _ring([REPLAYED] * 5, size=4 * 4 + 3))
    assert READ(_obs('test', 5)) is None
    monkeypatch.setattr(spans, 'RING', _ring([REPLAYED] * 5))
    assert READ(_obs('test', 0)) is None
    monkeypatch.setitem(sys.modules, 'dualsuperreslearningforsemseg_tpu_torch.utils.spans', None)
    assert READ(_obs('test', 5)) is None


def test_the_test_cell_lists_it():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        m = {m['name']: m for m in json.load(f)['per_layer']}['graph_replay_pct.test']
    assert (m['unit'], m['better'], m['source'], m['layer'], m['moves']) == \
        ('%', 'higher', 'program_span', 'host', 'test_p95_ms')
    assert 'graph_replay_pct.test' in {p['name'] for p in core.Cell('stage1_test_b1').per_layer}
    assert 'graph_replay_pct.test' not in {p['name'] for p in core.Cell('stage1_eval_b16').per_layer}
