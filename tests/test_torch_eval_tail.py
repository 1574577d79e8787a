"""The port's eval tail (ops/eval_tail.py, plain version on the CPU) against
the JAX package's Pallas kernel ``fused_convt2_eval`` in interpret mode and
against its XLA composition, on the same numpy inputs.

Tolerances: CE within rtol 1e-5 (float32 sums in another order); the class
map, the three histograms and the two counts equal.  The all-ties case runs
at a smaller shape: its CE is one value repeated at every pixel, the worst
case for the JAX side's float32 sums (at 4096 pixels they drift 2e-5 from
log(19) per pixel, which the port's float64 sum keeps).

The bfloat16 cases hand both sides the same bfloat16 activation: the TPU
kernel rounds the weight to bfloat16 for every product and sums in float32
with a float32 bias, and so does the port.  The CE agrees within rtol 1e-5
and the histograms and counts equal the Pallas kernel's; the class map
equals the argmax of float64 logits of the same bfloat16 values.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dualsuperreslearningforsemseg_tpu.losses import cross_entropy_loss
from dualsuperreslearningforsemseg_tpu.metrics.device import (
    argmax_lastdim, batch_histograms, batch_accuracy_counts)
from dualsuperreslearningforsemseg_tpu.ops.conv import (
    conv_transpose_2x2_stride2, group_labels_g16_t, ungroup_2x2)
from dualsuperreslearningforsemseg_tpu.ops.pallas.eval_tail import fused_convt2_eval
from dualsuperreslearningforsemseg_tpu_torch.ops.eval_tail import eval_tail
from tail_layout import to_cols

CASES = ['ignore_rows', 'all_ignored', 'all_ties', 'labels_25_40', 'all_nan', 'padded_sample']


def _case(rng, name, b=2, h=8, w=16):
    c = 19
    y1 = rng.standard_normal((b, h, w, 4, c)).astype(np.float32)
    wt = (rng.standard_normal((c, c, 2, 2)) * 0.2).astype(np.float32)
    bi = (rng.standard_normal((c,)) * 0.1).astype(np.float32)
    seg = rng.integers(0, c, size=(b, h * 4, w * 4)).astype(np.int32)
    if name == 'ignore_rows':
        seg[0, :5] = 255
    elif name == 'all_ignored':
        seg[:] = 255
    elif name == 'all_ties':
        wt[:] = 0.0
        bi[:] = 0.0
    elif name == 'labels_25_40':
        seg[0, :3] = 25
        seg[1, :2] = 40
    elif name == 'all_nan':
        y1[:] = np.nan
    elif name == 'padded_sample':
        seg[1] = 255          # what the eval step makes of a masked sample
    return y1, wt, bi, seg


@pytest.mark.parametrize('name', CASES)
def test_eval_tail_matches_jax(rng, name):
    y1, wt, bi, seg = _case(rng, name, *((1, 4, 8) if name == 'all_ties' else ()))
    full = ungroup_2x2(jnp.asarray(y1))                     # (B, 2H, 2W, C)

    # JAX: the Pallas kernel (interpret mode) and the XLA composition.
    pred_t, ce_pallas, hists_pallas, acc_pallas = fused_convt2_eval(
        to_cols(jnp.asarray(y1)), jnp.asarray(wt), jnp.asarray(bi),
        group_labels_g16_t(jnp.asarray(seg)), 255, 19, interpret=True)
    logits = conv_transpose_2x2_stride2(full, jnp.asarray(wt), jnp.asarray(bi))
    ce_xla = cross_entropy_loss(logits, jnp.asarray(seg), 255)
    pred_xla = argmax_lastdim(logits)
    hists_xla = batch_histograms(pred_xla, jnp.asarray(seg), 19, 255)
    acc_xla = batch_accuracy_counts(pred_xla, jnp.asarray(seg), 255)

    # The port, on CPU tensors (its plain version), NCHW.
    x = torch.from_numpy(np.ascontiguousarray(np.asarray(full).transpose(0, 3, 1, 2)))
    pred, ce_sum, areas, (correct, valid) = eval_tail(
        x, torch.from_numpy(wt), torch.from_numpy(bi),
        torch.from_numpy(seg.astype(np.uint8)), 255)
    ce = float(ce_sum) / int(valid) if int(valid) else 0.0

    assert pred.dtype == torch.uint8 and tuple(pred.shape) == seg.shape
    np.testing.assert_array_equal(pred.numpy(), np.asarray(pred_xla))
    for ref_ce, ref_hists, ref_acc in ((ce_pallas, hists_pallas, acc_pallas),
                                       (ce_xla, hists_xla, acc_xla)):
        np.testing.assert_allclose(ce, float(ref_ce), rtol=1e-5, atol=1e-7)
        for mine, ref in zip(areas, ref_hists):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
        assert (int(correct), int(valid)) == (int(ref_acc[0]), int(ref_acc[1]))
    if name == 'all_nan':
        assert np.isnan(ce) and int(pred.min()) == int(pred.max()) == 18
    if name == 'all_ties':
        assert int(pred.max()) == 0
        np.testing.assert_allclose(ce, np.log(19.0), rtol=1e-6)
    if name in ('all_ignored', 'padded_sample'):
        assert int(valid) == int((seg != 255).sum()) == int(areas[0].sum())


@pytest.mark.parametrize('name', CASES)
def test_eval_tail_bf16_matches_jax(rng, name):
    y1, wt, bi, seg = _case(rng, name, *((1, 4, 8) if name == 'all_ties' else ()))
    y1 = jnp.asarray(y1).astype(jnp.bfloat16)
    _, ce_pallas, hists_pallas, acc_pallas = fused_convt2_eval(
        to_cols(y1), jnp.asarray(wt), jnp.asarray(bi), group_labels_g16_t(jnp.asarray(seg)),
        255, 19, interpret=True)

    full = np.asarray(ungroup_2x2(y1).astype(jnp.float32))        # exact bfloat16 values
    x = torch.tensor(np.ascontiguousarray(full.transpose(0, 3, 1, 2))).to(torch.bfloat16)
    pred, ce_sum, areas, (correct, valid) = eval_tail(
        x, torch.from_numpy(wt), torch.from_numpy(bi), torch.from_numpy(seg.astype(np.uint8)), 255)
    ce = float(ce_sum) / int(valid) if int(valid) else 0.0

    wb = torch.from_numpy(wt).to(torch.bfloat16).double()
    logits = torch.nn.functional.conv_transpose2d(
        torch.tensor(full).permute(0, 3, 1, 2).double(), wb, torch.from_numpy(bi).double(),
        stride=2)
    assert pred.dtype == torch.uint8 and tuple(pred.shape) == seg.shape
    if name != 'all_nan':
        np.testing.assert_array_equal(pred.numpy(), logits.argmax(1).numpy())
    np.testing.assert_allclose(ce, float(ce_pallas), rtol=1e-5, atol=1e-7)
    for mine, ref in zip(areas, hists_pallas):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    assert (int(correct), int(valid)) == (int(acc_pallas[0]), int(acc_pallas[1]))
    if name == 'all_nan':
        assert np.isnan(ce) and int(pred.min()) == int(pred.max()) == 18
