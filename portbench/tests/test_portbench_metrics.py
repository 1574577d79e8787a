"""The harness's arithmetic: seeded inputs, statistics, the trace's idle
share and breakdown, the rooflines and the step's share of the peak."""

import pytest
import torch

from portbench import roofline, seeds, stats
from portbench.inputs import frame_pool
from portbench.layer_metrics import _common
from portbench.trace import MARKER, kernel_seconds, reduce_events
from portbench.weights import make_state

from .conftest import tiny_cell


def test_pools_repeat_for_one_seed_and_differ_for_two():
    big = 2 ** 31 + 12345
    a, la = frame_pool(big, 3, (32, 64), 'cpu')
    b, lb = frame_pool(big, 3, (32, 64), 'cpu')
    c, lc = frame_pool(big + 1, 3, (32, 64), 'cpu')
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert not torch.equal(a, c) and not torch.equal(la, lc)
    assert a.dtype == la.dtype == torch.uint8 and int(la.max()) <= 33
    assert torch.equal(la[:, :16, :16], la[:, :1, :1].expand(-1, 16, 16))


def test_weights_repeat_for_one_seed_and_differ_for_two():
    cfg = tiny_cell('stage3_train_b8').cfg
    a, b = make_state(cfg, 5, 'cpu'), make_state(cfg, 5, 'cpu')
    c = make_state(cfg, 6, 'cpu')
    assert a.keys() == c.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['SSSR_decoder.cls_conv.weight'], c['SSSR_decoder.cls_conv.weight'])
    w = a['feature_extractor.backbone.layer3.0.conv2.weight']
    assert abs(float(w.std()) - (2.0 / (w.shape[0] * 9)) ** 0.5) < 0.1 * (2.0 / (w.shape[0] * 9)) ** 0.5
    assert float(a['feature_extractor.backbone.layer1.0.bn3.weight'][0]) == cfg['bn3_gamma']
    assert float(a['feature_extractor.backbone.layer1.0.bn1.weight'][0]) == 1.0


def test_subseeds_take_any_whole_number():
    s = {seeds.subseed(2 ** 33 + 1, use) for use in range(7)}
    assert len(s) == 7 and all(0 <= x < 2 ** 62 for x in s)
    assert seeds.subseed(0, 1) == seeds.subseed(0, 1)


def test_the_tail_is_over_all_samples():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile(list(reversed(xs)), 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1.0] * 94 + [100.0] * 6, 95) > 50.0


def test_the_rate_is_all_the_window_s_work_over_all_its_time():
    from .conftest import tiny_cell
    from portbench import core
    cell = tiny_cell('stage1_train_b8')
    drv = core.driver(cell, 17, 'cpu')
    drv.setup()
    obs = drv.window(0.5)
    tr = cell.traffic
    assert obs['steps'] == drv.k - tr['checked_steps'] - tr['warm_steps'] > 0
    assert obs['images'] == obs['steps'] * tr['batch']
    assert obs['e2e']['train_img_per_s'] == pytest.approx(obs['images'] / obs['window_s'])
    assert obs['window_s'] >= 0.5


def _synthetic_trace():
    us = 1000
    return [
        (False, MARKER, 0, 1000 * us),
        (False, 'aten::conv', 0, 100 * us),
        (True, 'conv_kernel', 10 * us, 300 * us),
        (True, 'other_kernel', 200 * us, 400 * us),       # overlaps: busy once
        (False, 'cudaStreamSynchronize', 400 * us, 700 * us),
        (True, 'fused_tail_fwd_kernel<float>', 600 * us, 700 * us),
        (True, 'late', 990 * us, 1200 * us),              # clipped to the window
    ]


def test_idle_share_and_breakdown_from_a_synthetic_trace():
    t = reduce_events(_synthetic_trace())
    assert t['window_s'] == pytest.approx(1e-3)
    assert t['busy_s'] == pytest.approx((390 + 100 + 10) * 1e-6)
    assert _common.idle_pct({'trace': t}) == pytest.approx(50.0)
    gaps = dict(t['idle_gaps'])
    assert gaps['cudaStreamSynchronize'] == pytest.approx(200e-6)
    assert gaps['(no host op)'] == pytest.approx(290e-6)
    assert gaps['aten::conv'] == pytest.approx(10e-6)
    assert t['device_ops'][0] == ['conv_kernel', pytest.approx(290e-6)]
    assert kernel_seconds(t, _common.K1) == (pytest.approx(100e-6), 1)


def test_kernel_bounds_from_shapes():
    b, hw, c = 8, (512, 1024), 19
    px = b * hw[0] * hw[1]
    xb = px // 4 * c * 4
    fwd = max((xb + px + (c * c * 4 + c) * 4 + 16) / 3.35e12, 3 * px * 2 * c * c / 495e12,
              px * 6 * c / 67e12)
    bwd = max((2 * xb + px + 2 * (c * c * 4 + c) * 4 + 4) / 3.35e12, 3 * 3 * px * 2 * c * c / 495e12,
              px * 9 * c / 67e12)
    assert roofline.k1_bound_s(b, hw, c) == pytest.approx(fwd + bwd)
    assert 0.07e-3 < roofline.k1_bound_s(b, hw, c) < 0.09e-3
    assert 0.045e-3 < roofline.k3_bound_s(16, hw, c) < 0.06e-3


def test_roofline_and_mfu_readers():
    cell = tiny_cell('stage1_train_b8')
    bound = roofline.k1_bound_s(4, cell.cfg['output_hw'], 19)
    trace = {'window_s': 2.0, 'busy_s': 1.5, 'steps': 5,
             'kernel_s': {'void fused_tail_fwd_kernel<float>(...)': 10 * bound,
                          'fwd_sum_kernel': 0.0, 'void fused_tail_bwd_kernel<float>(...)': 10 * bound,
                          'bwd_sum_kernel': 0.0},
             'kernel_n': {'void fused_tail_fwd_kernel<float>(...)': 5, 'fwd_sum_kernel': 5,
                          'void fused_tail_bwd_kernel<float>(...)': 5, 'bwd_sum_kernel': 5}}
    obs = {'trace': trace, 'steps': 6, 'window_s': 3.0, 'cfg': cell.cfg, 'traffic': cell.traffic}
    assert _common.k1_roofline(obs) == pytest.approx(25.0)
    assert _common.k3_roofline(obs) is None
    flops = roofline.model_flops(cell.cfg, 4, True)
    assert _common.step_mfu(obs) == pytest.approx(100 * flops * 6 / 3.0 / 989e12)


def test_model_flops_count_the_backward_too():
    cfg = tiny_cell('stage1_eval_b16').cfg
    fwd = roofline.model_flops(cfg, 2, False)
    train = roofline.model_flops(cfg, 2, True)
    assert fwd > 0 and 2.5 * fwd < train < 3.5 * fwd
    assert roofline.model_flops(cfg, 4, False) == 2 * fwd
