"""The frozen reference against the program's CPU path at the small size, on
the same weights and inputs.  The test imports both; the reference imports
nothing of the program (test_portbench_manifest.py)."""

import numpy as np
import pytest
import torch

from portbench.drivers.common import port, port_model
from portbench.inputs import frame_pool
from portbench.reference import augment, losses
from portbench.reference.model import DSRL
from portbench.weights import load_into, make_state

from .conftest import tiny_cell


def _pair(stage, seed=3):
    cfg = tiny_cell('stage3_train_b8' if stage == 3 else 'stage1_train_b8').cfg
    state = make_state(cfg, seed, 'cpu')
    prog = load_into(port_model(cfg), state)
    ref = load_into(DSRL(cfg['num_classes'], cfg['stage'], cfg['backbone_layers']), state)
    return cfg, prog, ref


def test_same_parameter_and_buffer_names():
    for stage in (1, 3):
        cfg, prog, ref = _pair(stage)
        assert list(prog.state_dict()) == list(ref.state_dict())


@pytest.mark.parametrize('stage', [1, 3])
def test_eval_forward_agrees(stage):
    cfg, prog, ref = _pair(stage)
    x = torch.randn(2, 3, *cfg['input_hw'], generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = prog.eval()(x)
        b = ref.eval()(x)
    assert [p is None for p in a] == [r is None for r in b]
    for p, r in ((p, r) for p, r in zip(a, b) if r is not None):
        assert torch.allclose(p, r, rtol=1e-4, atol=1e-5 * float(r.abs().max())), float((p - r).abs().max())


def test_warp_matrices_and_warp_agree():
    P = port()
    cfg = tiny_cell('stage1_train_b8').cfg
    aug = P.data.AugmentConfig(input_hw=tuple(cfg['input_hw']), output_hw=tuple(cfg['output_hw']),
                               **{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in cfg['augment'].items()})
    for k in range(4):
        ss = np.random.SeedSequence([2 ** 40 + 9, 0, k])
        a = P.data.augment.sample_affine_matrices_np(np.random.default_rng(ss), 4, (256, 512),
                                                      cfg['output_hw'], aug)
        b = augment.affine_matrices(np.random.default_rng(ss), 4, (256, 512), cfg['output_hw'],
                                    cfg['augment'])
        np.testing.assert_array_equal(a, b)
    imgs, segs = frame_pool(7, 4, (256, 512), 'cpu')
    lut = np.array(cfg['label_map'], np.uint8)
    ia, sa = P.data.augment.warp_pair_batch(imgs, segs, torch.from_numpy(a), cfg['output_hw'], lut)
    ib, sb = augment.warp(imgs, segs, b, cfg['output_hw'], cfg['label_map'])
    assert torch.equal(sa, sb)
    assert int((ia.int() - ib.int()).abs().max()) <= 1 and float((ia != ib).float().mean()) < 1e-3


def test_photometric_and_eval_transforms_agree():
    P = port()
    cfg = tiny_cell('stage1_train_b8').cfg
    aug_cfg = P.data.AugmentConfig(input_hw=tuple(cfg['input_hw']), output_hw=tuple(cfg['output_hw']),
                                   mean=tuple(cfg['mean']), std=tuple(cfg['std']),
                                   **{k: tuple(v) if isinstance(v, list) else v
                                      for k, v in cfg['augment'].items()})
    imgs, segs = frame_pool(8, 4, tuple(cfg['output_hw']), 'cpu')
    post = P.data.make_device_post_fn(aug_cfg, torch.float32, unshuffle_hi=8)
    (lo, hi), (seg_hi, _) = post(imgs, segs, torch.Generator().manual_seed(11))
    taps, mix = augment.photometric_draws(torch.Generator().manual_seed(11), 4, cfg['augment'])
    ref_hi = augment.photometric(imgs, taps, mix, cfg['mean'], cfg['std'])
    ref_lo = augment.resize(ref_hi, cfg['input_hw'])
    assert torch.allclose(hi.permute(0, 3, 1, 2), torch.nn.functional.pixel_unshuffle(ref_hi, 8), atol=2e-5)
    assert torch.allclose(lo.permute(0, 3, 1, 2), ref_lo, atol=2e-5)
    assert torch.equal(seg_hi, segs)
    frames, ids = frame_pool(9, 2, (256, 512), 'cpu')
    tf = P.data.make_eval_transform_fn(tuple(cfg['input_hw']), tuple(cfg['output_hw']),
                                       tuple(cfg['mean']), tuple(cfg['std']),
                                       np.array(cfg['label_map'], np.uint8))
    (e_lo, _), (e_seg, _) = tf(frames, ids)
    r_lo = augment.resize(augment.normalise(frames, cfg['mean'], cfg['std']), cfg['input_hw'])
    assert torch.allclose(e_lo.permute(0, 3, 1, 2), r_lo, atol=5e-4)
    assert torch.equal(e_seg, augment.eval_labels(ids, cfg['output_hw'], cfg['label_map']))


def test_losses_and_tallies_agree():
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(2, 19, 16, 32, generator=g)
    labels = torch.randint(0, 19, (2, 16, 32), generator=g).to(torch.uint8)
    labels[:, :4] = 255
    from dualsuperreslearningforsemseg_tpu_torch.losses import cross_entropy_loss, fa_loss, mse_loss
    from dualsuperreslearningforsemseg_tpu_torch.metrics.device import (batch_accuracy_counts,
                                                                       batch_histograms)
    ce_r, n = losses.cross_entropy(logits, labels)
    assert float(ce_r) == pytest.approx(float(cross_entropy_loss(logits.permute(0, 2, 3, 1), labels)), rel=1e-6)
    a, b = torch.randn(2, 3, 16, 32, generator=g), torch.randn(2, 3, 16, 32, generator=g)
    assert float(losses.mse(a, b)) == pytest.approx(float(mse_loss(a, b)), rel=1e-6)
    f1 = torch.relu(torch.randn(2, 1, 64, 128, generator=g))
    f2 = torch.relu(torch.randn(2, 1, 64, 128, generator=g))
    assert float(losses.fa(f1, f2)) == pytest.approx(float(fa_loss(f1, f2)), rel=1e-5)
    pred = logits.argmax(1)
    areas, counts = losses.tallies(pred, labels, 19)
    for x, y in zip(areas, batch_histograms(pred, labels, 19)):
        assert torch.equal(x, y)
    assert counts == tuple(int(v) for v in batch_accuracy_counts(pred, labels))
