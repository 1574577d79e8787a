"""The port's matmul resize (``ops/resize.py``) against the JAX package's
``resize_bilinear_matmul``, at the model's three in-graph shapes with
narrow channel counts: the ASPP's pooled branch 1x1 -> 16x32, x4 after the
ASPP 16x32 -> 64x128, and the decoder's x2 64x128 -> 128x256; and at the
x4 of the test suite's 64x128 input, 4x8 -> 16x32.

Both compute the same two-term lerps in float32 from the same float32
matrices, in another order of products and sums (and with or without a
fused multiply-add).  An output is two products and one sum, and an input
gradient a sum of a few such products (of up to 512 for the 1x1 input), so
in float32 they differ by a few ulps of the largest value (2^-23 = 1.2e-7
each): within 1e-6 of the largest value.  At 4x8 -> 16x32 XLA adds
separately rounded products, as the port's forward does, so the outputs
are bit-equal there (the parity tests of the train step run that shape).
bfloat16 inputs are cast to float32, resized and rounded once to bfloat16
by both, so they agree within one bfloat16 ulp (a float32 value an ulp
apart may round the other way).  The port's DSRL keeps the state-dict
names the JAX package writes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualsuperreslearningforsemseg_tpu.models import DSRL as JaxDSRL
from dualsuperreslearningforsemseg_tpu.ops.resize import resize_bilinear_matmul as jax_resize
from dualsuperreslearningforsemseg_tpu_torch.models import DSRL, port_state_dict_from_jax
from dualsuperreslearningforsemseg_tpu_torch.ops.resize import resize_bilinear_matmul

SHAPES = [((1, 1), (16, 32)), ((16, 32), (64, 128)), ((64, 128), (128, 256)), ((4, 8), (16, 32))]
CHANNELS = 3


def _inputs(in_hw, out_hw, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, CHANNELS, *in_hw)).astype(np.float32)
    g = rng.standard_normal((2, CHANNELS, *out_hw)).astype(np.float32)
    return x, g


def _jax_value_and_grad(x, g, out_hw, dtype):
    """JAX resize of NCHW numpy ``x`` (run NHWC) and its vjp with ``g``."""
    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(dtype)
    y, vjp = jax.vjp(lambda t: jax_resize(t, out_hw), nhwc)
    (dx,) = vjp(jnp.asarray(g.transpose(0, 2, 3, 1)).astype(dtype))
    return (np.asarray(y.astype(jnp.float32)).transpose(0, 3, 1, 2),
            np.asarray(dx.astype(jnp.float32)).transpose(0, 3, 1, 2))


def _bf16_ulp(a):
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize('in_hw,out_hw', SHAPES)
def test_float32_values_and_gradients_match_jax(in_hw, out_hw):
    x, g = _inputs(in_hw, out_hw, seed=in_hw[0])
    y_ref, dx_ref = _jax_value_and_grad(x, g, out_hw, jnp.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = resize_bilinear_matmul(xt, out_hw)
    y.backward(torch.from_numpy(g))
    assert y.dtype == torch.float32 and tuple(y.shape) == (2, CHANNELS, *out_hw)
    for got, ref in ((y.detach().numpy(), y_ref), (xt.grad.numpy(), dx_ref)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    if in_hw == (4, 8):
        np.testing.assert_array_equal(y.detach().numpy(), y_ref)


@pytest.mark.parametrize('in_hw,out_hw', SHAPES)
def test_bfloat16_under_autocast_matches_jax(in_hw, out_hw):
    x, g = _inputs(in_hw, out_hw, seed=10 + in_hw[0])
    y_ref, dx_ref = _jax_value_and_grad(x, g, out_hw, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    with torch.autocast('cpu', dtype=torch.bfloat16):
        y = resize_bilinear_matmul(xt, out_hw)
    y.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16
    for got, ref in ((y.detach().float().numpy(), y_ref), (xt.grad.float().numpy(), dx_ref)):
        assert np.all(np.abs(got - ref) <= _bf16_ulp(ref)), np.abs(got - ref).max()


def test_state_dict_names_unchanged():
    """The parameterless resize module keeps ``upsample16_pred``'s indices:
    the port's stage-3 state dict has exactly the JAX package's names and
    shapes, so its ``.weights`` load with strict=True."""
    layers = (1, 1, 2, 1)
    shapes = jax.eval_shape(
        lambda: JaxDSRL(stage=3, num_classes=19, backbone_layers=layers).init(
            {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
            jnp.zeros((1, 64, 128, 3), jnp.float32), False))
    jax_names = port_state_dict_from_jax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    port = DSRL(num_classes=19, stage=3, backbone_layers=layers).state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(v.shape) for k, v in jax_names.items()}
    assert not [k for k in port if k.startswith('SSSR_decoder.upsample16_pred.0')]
