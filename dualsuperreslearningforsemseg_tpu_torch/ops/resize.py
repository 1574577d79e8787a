"""Bilinear ``align_corners=True`` resize as two products with constant
interpolation matrices, NCHW.

The port's copy of the JAX package's ``ops/resize.py`` functions
``_linear_indices_weights``, ``_interp_matrix`` and
``resize_bilinear_matmul``, which the model's three in-graph resizes call
(the ASPP's pooled branch, x4 after the ASPP, x2 at the head of
``upsample16_pred``).  Each output is the same two-term lerp as
``F.interpolate(mode='bilinear', align_corners=True)``, but the backward
is a product too: on the card, ``F.interpolate``'s backward accumulates
with atomics in an order that changes from run to run, and this one does
not, so the train step is bitwise repeatable.

The forward resizes each axis as the sum of two products,
``m0 @ x + m1 @ x``, where ``m0`` holds the JAX matrix's ``1 - frac``
weights and ``m1`` its ``frac`` weights (``m0 + m1`` is
``_interp_matrix``).  Each row of either has one nonzero, so each product
gives the correctly rounded ``w * x`` whatever the library's order of sums
or use of fused multiply-adds, and their sum is rounded once: the bits of
XLA's CPU lowering of the JAX function at the test suite's small sizes,
which adds separately rounded products (one product with the whole
matrix, through a fused multiply-add, differs there in a third of the
values, and the stage-3 parity test over three SGD steps amplifies that).
The backward is the JAX function's transpose, one product with the whole
matrix per axis.  The matrices are made with numpy in float32, as the JAX
package makes them, and kept per (in size, out size, device): they are
constants, not parameters or buffers, so the state dict does not change.
"""

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _linear_indices_weights(in_size: int, out_size: int):
    """Indices and weights of 1-D align_corners=True linear interpolation:
    output j reads source position j*(I-1)/(O-1) (0 when O == 1 or I == 1)
    and lerps between its floor and ceil."""
    if out_size == 1 or in_size == 1:
        src = np.zeros(out_size, dtype=np.float64)
    else:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    i0 = np.clip(np.floor(src).astype(np.int32), 0, in_size - 1)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    frac = (src - i0).astype(np.float32)
    return i0, i1, frac


@functools.lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int):
    """Dense (out, in) float32 interpolation matrix, two nonzeros a row."""
    i0, i1, frac = _linear_indices_weights(in_size, out_size)
    m = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, i0), 1.0 - frac)
    np.add.at(m, (rows, i1), frac)
    return m


@functools.lru_cache(maxsize=None)
def _matrices_on(in_size: int, out_size: int, device: torch.device):
    """(m, m0, m1) on ``device``, copied there once: :func:`_interp_matrix`
    and its parts of the ``1 - frac`` and the ``frac`` weights (m0 + m1 = m,
    one nonzero a row each)."""
    i0, i1, frac = _linear_indices_weights(in_size, out_size)
    rows = np.arange(out_size)
    m0 = np.zeros((out_size, in_size), dtype=np.float32)
    m1 = np.zeros((out_size, in_size), dtype=np.float32)
    m0[rows, i0] = 1.0 - frac
    m1[rows, i1] = frac
    m = _interp_matrix(in_size, out_size)
    return tuple(torch.from_numpy(t).to(device) for t in (m, m0, m1))


class _ResizeBilinear(torch.autograd.Function):
    """float32 (N, C, H, W) -> (N, C, out_h, out_w).  Forward: each axis as
    ``m0 @ x + m1 @ x``.  Backward: the JAX function's transpose, one
    product with ``m`` per axis, the W axis first."""

    @staticmethod
    def forward(ctx, x, out_h, out_w):
        in_h, in_w = x.shape[-2:]
        ctx.sizes = (in_h, in_w, out_h, out_w)
        y = x
        if in_h != out_h:
            _, m0, m1 = _matrices_on(in_h, out_h, x.device)
            y = torch.matmul(m0, y) + torch.matmul(m1, y)
        if in_w != out_w:
            _, m0, m1 = _matrices_on(in_w, out_w, x.device)
            y = torch.matmul(y, m0.T) + torch.matmul(y, m1.T)
        return y

    @staticmethod
    def backward(ctx, g):
        in_h, in_w, out_h, out_w = ctx.sizes
        with torch.autocast(g.device.type, enabled=False):
            g = g.float()
            if in_w != out_w:
                g = torch.matmul(g, _matrices_on(in_w, out_w, g.device)[0])
            if in_h != out_h:
                g = torch.matmul(_matrices_on(in_h, out_h, g.device)[0].T, g)
        return g, None, None


def resize_bilinear_matmul(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, out_h, out_w): ``mh @ x @ mw.T`` (the module
    docstring), skipping an axis whose size does not change.  Runs in
    float32 with autocast off (under bfloat16 autocast a bare product would
    round the weights) and returns ``x``'s dtype, as the JAX function
    does."""
    with torch.autocast(x.device.type, enabled=False):
        y = _ResizeBilinear.apply(x.float(), int(out_hw[0]), int(out_hw[1]))
    return y.to(x.dtype)
