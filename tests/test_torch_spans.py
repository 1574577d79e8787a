"""The port's spans (utils/spans.py) on the CPU: nesting and parents, the
window rule over set-up, untraced and profiled steps, a ring that has come
round, the spans on the profiler's clock, and a stage-3 train step's spans
in order, with a step unchanged by a full ring; the ``test`` command's
per-frame pipeline on the CPU (eager, its three spans, the class maps and
``network_input`` of the arithmetic it had before it kept its constants)."""

import numpy as np
import pytest
import torch

from dualsuperreslearningforsemseg_tpu_torch.data import AugmentConfig, make_device_post_fn
from dualsuperreslearningforsemseg_tpu_torch.datasets import cityscapes
from dualsuperreslearningforsemseg_tpu_torch.models import DSRL, init_weights
from dualsuperreslearningforsemseg_tpu_torch.models.dsrl import SISR_UPSCALE
from dualsuperreslearningforsemseg_tpu_torch.train import make_sgd, make_train_step
from dualsuperreslearningforsemseg_tpu_torch.utils import spans


def _steps(ring, n, inner=1):
    for _ in range(n):
        with ring.span('step'):
            for _ in range(inner):
                with ring.span('inner'):
                    pass


def test_nesting_and_parents():
    ring = spans.Ring(16)
    with ring.span('a') as a:
        with ring.span('b') as b:
            with ring.span('c') as c:
                pass
        with ring.span('d') as d:
            pass
    with pytest.raises(ValueError):
        with ring.span('e'):
            raise ValueError
    assert ring.open is None
    recs = [ring.record(s) for s in ring.held()]
    assert [r.name for r in recs] == ['a', 'b', 'c', 'd', 'e']
    assert [r.parent for r in recs] == [None, a.seq, b.seq, a.seq, None]
    assert [r.seq for r in recs] == [a.seq, b.seq, c.seq, d.seq, 4]
    assert all(r.end_ns >= r.start_ns and not r.profiled and r.device_ms is None for r in recs)
    assert (recs[0].start_ns <= recs[1].start_ns <= recs[2].end_ns <= recs[1].end_ns
            <= recs[0].end_ns)
    assert a.seconds == pytest.approx(recs[0].host_ms * 1e-3)


def test_the_window_is_the_untraced_steps_before_the_profiled_ones():
    ring, n = spans.Ring(), 4
    _steps(ring, 3)                       # set-up's checked and warm steps
    first = ring.next_seq
    _steps(ring, n, inner=2)              # the untraced window
    end = ring.next_seq
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _steps(ring, 2)                   # the profiled window
    _steps(ring, 1)                       # after it (the reference's comparison)
    recs = ring.window('step', n)
    assert [r.seq for r in recs] == list(range(first, end))
    assert [r.name for r in recs] == ['step', 'inner', 'inner'] * n
    assert not any(r.profiled for r in recs)
    assert all(ring.record(s).profiled for s in range(end, end + 4))
    assert not ring.record(end + 4).profiled
    assert ring.window('step', 7) == [ring.record(s) for s in range(0, end)]
    assert ring.window('step', 8) is None
    # with nothing profiled, up to the newest record
    plain = spans.Ring()
    _steps(plain, 5)
    assert [r.seq for r in plain.window('step', 2)] == list(range(6, 10))
    # another loop profiled before the marker's first step (one process, two cells)
    mixed = spans.Ring()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _steps(mixed, 1)
        with mixed.span('other'):
            pass
    _steps(mixed, 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _steps(mixed, 1)
    assert [r.seq for r in mixed.window('step', 3)] == list(range(3, 9))
    assert mixed.window('step', 4) is None


def test_a_ring_that_came_round_reads_none():
    ring = spans.Ring(6)
    _steps(ring, 4)                      # 8 records: the first two overwritten
    assert list(ring.held()) == list(range(2, 8))
    assert ring.window('step', 4) is None
    assert [r.seq for r in ring.window('step', 3)] == list(range(2, 8))
    # a span open while the ring comes round leaves the newer records alone
    with ring.span('outer'):
        _steps(ring, 4)
    assert ring.record(ring.next_seq - 1).name == 'inner'
    assert all(ring.record(s).end_ns is not None for s in ring.held())


def test_a_span_lies_on_the_profilers_clock():
    """The closest of 20 spans: a busy host can preempt the thread between the
    profiler's stamp and the span's."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        opened = []
        for k in range(20):
            with spans.span('spans.clock_check{}'.format(k)) as s:
                pass
            opened.append(s.seq)
    recs = [spans.RING.record(seq) for seq in opened]
    assert all(r.profiled for r in recs)
    starts = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name().startswith('spans.clock_check')}
    assert set(starts) == {r.name for r in recs}
    assert min(abs(starts[r.name] - spans.to_trace_ns(r.start_ns)) for r in recs) < 100_000


LAYERS = (1, 1, 2, 1)
HW, OHW = (64, 128), (128, 256)


def _stage3_step(seed=2024, batch=2):
    """One stage-3 step (with the device photometric tail) from a fresh seeded
    model -> (losses, parameters, the sequence numbers before and after)."""
    torch.manual_seed(seed)
    model = init_weights(DSRL(num_classes=19, stage=3, backbone_layers=LAYERS),
                         torch.Generator().manual_seed(seed))
    optimizer = make_sgd(model, 0.01, 0.9, 5e-4)
    cfg = AugmentConfig(input_hw=HW, output_hw=OHW, mean=cityscapes.MEAN, std=cityscapes.STD)
    step = make_train_step(model, optimizer, 3, 0.1, 1.0, 255,
                           post_fn=make_device_post_fn(cfg, unshuffle_hi=SISR_UPSCALE))
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.integers(0, 256, size=(batch, *OHW, 3), dtype=np.uint8))
    segs = torch.from_numpy(rng.integers(0, 19, size=(batch, *OHW)).astype(np.uint8))
    gen = torch.Generator().manual_seed(seed)
    before = spans.RING.next_seq
    losses = step(imgs, segs, 0.01, gen)
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return losses, params, before, spans.RING.next_seq


def test_a_stage3_step_records_its_parts_in_order_and_a_full_ring_changes_nothing():
    losses, params, before, after = _stage3_step()
    recs = [spans.RING.record(s) for s in range(before, after)]
    assert [r.name for r in recs] == ['train.step', 'data.post', 'train.forward', 'train.loss',
                                      'losses.fa', 'train.backward', 'train.optimizer']
    step, post, forward, loss, fa, backward, opt = recs
    assert step.parent is None
    assert all(r.parent == step.seq for r in (post, forward, loss, backward, opt))
    assert fa.parent == loss.seq
    assert all(r.end_ns is not None and r.device_ms is None for r in recs)
    assert all(a.end_ns <= b.start_ns for a, b in zip([post, forward, loss, backward],
                                                      [forward, loss, backward, opt]))
    for _ in range(spans.RING_SIZE + 7):     # the ring full and come round
        with spans.span('filler'):
            pass
    losses2, params2, _, _ = _stage3_step()
    assert all(torch.equal(losses[k], losses2[k]) for k in losses)
    assert all(torch.equal(params[k], params2[k]) for k in params)
    assert list(losses) == ['CE', 'MSE', 'FA', 'Total']


def _parent_input(img_u8, device):
    """The network input as the test pipeline computed it before it kept its
    constants: new mean and std tensors and a new frame copy each call."""
    mean = torch.tensor(cityscapes.MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(cityscapes.STD, dtype=torch.float32, device=device)
    x = (torch.tensor(img_u8, device=device).float() / 255.0 - mean) / std
    return torch.nn.functional.interpolate(x.permute(2, 0, 1)[None], size=HW, mode='bilinear',
                                           align_corners=True)


def _frames(shape, n=3, seed=17):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(*shape, 3), dtype=np.uint8) for _ in range(n)]


def test_network_input_keeps_its_signature_and_output():
    import inspect
    from dualsuperreslearningforsemseg_tpu_torch import settings
    from dualsuperreslearningforsemseg_tpu_torch.commands.test import network_input
    assert list(inspect.signature(network_input).parameters) == ['img_u8', 'ds_settings', 'device']
    assert tuple(settings.MODEL_INPUT_SIZE) == HW
    cpu = torch.device('cpu')
    for img in _frames(OHW) + _frames((70, 150)):
        x = network_input(img, cityscapes, cpu)
        assert x.dtype == torch.float32 and x.shape == (1, 3, *HW)
        assert torch.equal(x, _parent_input(img, cpu))


@pytest.mark.parametrize('shape', [OHW, (70, 150)])
def test_the_cpu_test_pipeline_runs_eagerly_with_its_three_spans(shape):
    """On the CPU ``_build_pipeline`` keeps the eager path: the class maps of
    the parent's arithmetic, and per frame ``test.input``, ``test.forward``
    and ``test.readback`` with no ``test.capture`` or ``test.replay``."""
    from dualsuperreslearningforsemseg_tpu_torch.commands.test import _build_pipeline
    from dualsuperreslearningforsemseg_tpu_torch.metrics.device import argmax_lastdim
    cpu = torch.device('cpu')
    model = init_weights(DSRL(num_classes=19, backbone_layers=LAYERS),
                         torch.Generator().manual_seed(5)).eval()
    pipeline = _build_pipeline(lambda x: model(x)[0], cityscapes, cpu)
    frames = _frames(shape)
    before = spans.RING.next_seq
    maps = [pipeline(img) for img in frames]
    recs = [spans.RING.record(s) for s in range(before, spans.RING.next_seq)]
    assert [r.name for r in recs] == ['test.input', 'test.forward', 'test.readback'] * len(frames)
    assert all(r.parent is None and r.device_ms is None for r in recs)
    with torch.inference_mode():
        for img, got in zip(frames, maps):
            logits = model(_parent_input(img, cpu))[0]
            ref = argmax_lastdim(logits[0].permute(1, 2, 0)).to(torch.uint8).numpy()
            assert got.dtype == np.uint8 and got.shape == OHW
            np.testing.assert_array_equal(got, ref)
