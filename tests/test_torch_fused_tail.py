"""The port's train tail (ops/fused_tail.py, plain version on the CPU)
against the JAX package's Pallas kernel ``fused_convt2_ce_mean`` in
interpret mode, on the same numpy inputs: the mean CE and its gradients
with respect to the activation, the ConvT weight and the bias.

The JAX kernel takes the grouped activation in its cols layout
(``tail_layout.to_cols``) and g16 labels; the port takes the natural NCHW
activation (``ungroup_2x2`` of the same values) and (B, 2H, 2W) labels, so
the port's dX is regrouped before the comparison.  Tolerances: the value
within 1e-5, the gradients within rtol 1e-5, atol 1e-7
(tests/test_pallas_tail.py:53-56).  With every pixel ignored the loss and
every gradient are exactly 0.

The bfloat16 cases hand both sides the same bfloat16 activation.  The TPU
kernel rounds the weight to bfloat16 for every product and the float32
dlogits to bfloat16 for the dX and dW products, sums in float32, adds the
bias and takes db in float32, and rounds dX to bfloat16; the port's plain
version follows the same rule.  Tolerances: the value within rtol 1e-5;
dX within one bfloat16 ulp of the JAX value; db within rtol 1e-5, atol
1e-7; dW within rtol 1e-5, atol 1e-7 except where a dlogit rounds to
bfloat16 the other way on the two sides.  A dlogit that lies within float32
noise (another summation order of the logits, another ``exp``) of a
bfloat16 rounding midpoint does so, and moves the 19 dW entries of its
(class, position) column by at most one bfloat16 ulp of the largest
dlogit, 2^-8 times the loss's scale 1/count, times max|x|.  So dW may
exceed the first bound in at most 2 of the 76 columns, and only by that
much; this file's seed has one such column (labels_25_40).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dualsuperreslearningforsemseg_tpu.ops.conv import group_labels_g16_t, ungroup_2x2
from dualsuperreslearningforsemseg_tpu.ops.pallas.fused_tail import (
    fused_convt2_ce_mean as jax_fused_convt2_ce_mean)
from dualsuperreslearningforsemseg_tpu_torch.ops.fused_tail import fused_convt2_ce_mean
from tail_layout import to_cols

CASES = ['ignore_rows', 'all_ignored', 'labels_25_40', 'ragged']


def _case(rng, name):
    b, h, w = (1, 4, 6) if name == 'ragged' else (2, 8, 16)
    c = 19
    y1 = rng.standard_normal((b, h, w, 4, c)).astype(np.float32)
    wt = (rng.standard_normal((c, c, 2, 2)) * 0.2).astype(np.float32)
    bi = (rng.standard_normal((c,)) * 0.1).astype(np.float32)
    seg = rng.integers(0, c, size=(b, 4 * h, 4 * w)).astype(np.int32)
    if name == 'ignore_rows':
        seg[0, :5] = 255
    elif name == 'all_ignored':
        seg[:] = 255
    elif name == 'labels_25_40':
        seg[0, :3] = 25
        seg[-1, -2:] = 40
        seg[0, 5:7] = 255
    return y1, wt, bi, seg


def _regroup(full_nhwc):
    """(B, 2H, 2W, C) -> (B, H, W, 4, C), the inverse of ungroup_2x2."""
    b, fh, fw, c = full_nhwc.shape
    x = full_nhwc.reshape(b, fh // 2, 2, fw // 2, 2, c).transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b, fh // 2, fw // 2, 4, c)


@pytest.mark.parametrize('name', CASES)
def test_fused_tail_matches_jax(rng, name):
    y1, wt, bi, seg = _case(rng, name)
    labs_t = group_labels_g16_t(jnp.asarray(seg))

    def jax_loss(y1, wt, bi):
        return jax_fused_convt2_ce_mean(to_cols(y1), wt, bi, labs_t, 255, interpret=True)

    value_j, grads_j = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(y1), jnp.asarray(wt), jnp.asarray(bi))

    full = np.asarray(ungroup_2x2(jnp.asarray(y1)))               # (B, 2H, 2W, C)
    x = torch.tensor(np.ascontiguousarray(full.transpose(0, 3, 1, 2)), requires_grad=True)
    weight = torch.tensor(wt, requires_grad=True)
    bias = torch.tensor(bi, requires_grad=True)
    loss = fused_convt2_ce_mean(x, weight, bias, torch.from_numpy(seg.astype(np.uint8)), 255)
    loss.backward()

    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss.detach()) - float(value_j)) < 1e-5
    np.testing.assert_allclose(float(loss.detach()), float(value_j), rtol=1e-5, atol=1e-7)
    dx = _regroup(x.grad.numpy().transpose(0, 2, 3, 1))
    for mine, ref in zip((dx, weight.grad.numpy(), bias.grad.numpy()), grads_j):
        np.testing.assert_allclose(mine, np.asarray(ref), rtol=1e-5, atol=1e-7)
    if name == 'all_ignored':
        assert float(loss.detach()) == 0.0
        for g in (x.grad, weight.grad, bias.grad):
            assert not bool(g.isnan().any()) and float(g.abs().max()) == 0.0


@pytest.mark.parametrize('name', CASES)
def test_fused_tail_bf16_matches_jax(rng, name):
    y1, wt, bi, seg = _case(rng, name)
    y1 = jnp.asarray(y1).astype(jnp.bfloat16)
    labs_t = group_labels_g16_t(jnp.asarray(seg))

    def jax_loss(y1, wt, bi):
        return jax_fused_convt2_ce_mean(to_cols(y1), wt, bi, labs_t, 255, interpret=True)

    value_j, grads_j = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        y1, jnp.asarray(wt), jnp.asarray(bi))

    full = np.asarray(ungroup_2x2(y1).astype(jnp.float32))        # exact bfloat16 values
    x = torch.tensor(np.ascontiguousarray(full.transpose(0, 3, 1, 2))).to(torch.bfloat16)
    x.requires_grad_()
    weight = torch.tensor(wt, requires_grad=True)
    bias = torch.tensor(bi, requires_grad=True)
    loss = fused_convt2_ce_mean(x, weight, bias, torch.from_numpy(seg.astype(np.uint8)), 255)
    loss.backward()

    assert loss.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(float(loss.detach()), float(value_j), rtol=1e-5, atol=1e-7)
    dx = _regroup(x.grad.float().numpy().transpose(0, 2, 3, 1))
    dx_j = np.asarray(grads_j[0].astype(jnp.float32))
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(dx_j), np.finfo(np.float32).tiny))) - 7)
    assert np.all(np.abs(dx - dx_j) <= ulp)
    np.testing.assert_allclose(bias.grad.numpy(), np.asarray(grads_j[2]), rtol=1e-5, atol=1e-7)
    dw, dw_j = weight.grad.numpy(), np.asarray(grads_j[1])
    diff, allowed = np.abs(dw - dw_j), 1e-5 * np.abs(dw_j) + 1e-7
    flip = 2.0 ** -8 / max(int((seg != 255).sum()), 1) * float(np.abs(full).max())
    assert np.all(diff <= allowed + flip)
    assert int((diff > allowed).any(axis=0).sum()) <= 2        # (class, kh, kw) columns
    if name == 'all_ignored':
        assert float(loss.detach()) == 0.0
        for g in (x.grad, weight.grad, bias.grad):
            assert not bool(g.isnan().any()) and float(g.abs().max()) == 0.0
