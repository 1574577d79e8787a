"""Fused eval tail: final ConvTranspose2d(C, C, 2, 2) + bias + masked CE +
argmax + the mIoU/accuracy counts, without writing the logits.

The port of the JAX package's Pallas kernel ``convt_cols_eval``
(ops/pallas/eval_tail.py).  :func:`eval_tail` launches the hand-written CUDA
kernel ``csrc/eval_tail.cu`` for CUDA tensors and runs
:func:`eval_tail_plain`, the same function in plain PyTorch, for CPU
tensors; the CPU tests and the card-side comparison in ``chip_smoke.py`` use
the plain version.  The kernel takes the natural NCHW activation: the TPU's
channel-padded-columns and g16 label layouts existed for its 128 lanes.
A bfloat16 activation (validation under ``--mixed-precision``) takes the
TPU kernel's rounding rule: the weight rounded to bfloat16 for every
product, float32 sums and a float32 bias (``ops/fused_tail.py::
tail_logits_plain``).

Both return ``(pred, ce_sum, (area_pred, area_inter, area_target),
(correct, valid))``: the (B, 2H, 2W) uint8 class map, the CE summed over
valid pixels as a float64 scalar, and int64 counts (the TPU counted in f32,
exact only below 2^24 pixels).
"""

import ctypes
import functools

import torch

from ..losses.cross_entropy import cross_entropy_sum
from ..metrics.device import argmax_lastdim, batch_histograms, batch_accuracy_counts
from ._build import declare, load_library
from .fused_tail import DTYPE_CODES, tail_logits_plain

_C_SIGNATURE = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def eval_tail_plain(x, weight, bias, labels, ignore_label: int = 255):
    """The plain PyTorch version: materialises the logits."""
    logits = tail_logits_plain(x, weight, bias).permute(0, 2, 3, 1)   # (B, 2H, 2W, C)
    pred = argmax_lastdim(logits)
    ce_sum, _ = cross_entropy_sum(logits, labels, ignore_label)
    areas = batch_histograms(pred, labels, weight.shape[1], ignore_label)
    return pred.to(torch.uint8), ce_sum, areas, batch_accuracy_counts(pred, labels, ignore_label)


def _check(x, weight, bias, labels):
    b, c, h, w = x.shape
    if weight.shape != (c, c, 2, 2) or bias.shape != (c,):
        raise ValueError("eval_tail: weight must be ({0},{0},2,2) and bias ({0},), got {1} and {2}"
                         .format(c, tuple(weight.shape), tuple(bias.shape)))
    if labels.shape != (b, 2 * h, 2 * w):
        raise ValueError("eval_tail: labels must be {}, got {}".format((b, 2 * h, 2 * w),
                                                                       tuple(labels.shape)))
    if x.dtype not in DTYPE_CODES:
        raise ValueError("eval_tail: x must be float32 or bfloat16, got {}".format(x.dtype))
    for name, t, dtype in (('x', x, x.dtype), ('weight', weight, torch.float32),
                           ('bias', bias, torch.float32), ('labels', labels, torch.uint8)):
        if t.dtype != dtype or not t.is_contiguous() or t.device != x.device:
            raise ValueError("eval_tail: {} must be a contiguous {} tensor on {}, got {} {}{}"
                             .format(name, dtype, x.device, t.dtype, t.device,
                                     '' if t.is_contiguous() else ' (not contiguous)'))
    if h * w >= 2 ** 31:
        raise ValueError("eval_tail: a sample's plane must hold fewer than 2^31 pixels")
    if labels.data_ptr() % 2:
        raise ValueError("eval_tail: labels must start at an even address (2-byte loads)")


@functools.lru_cache(maxsize=None)
def _library():
    return declare(load_library('eval_tail'), {'dsrl_eval_tail': _C_SIGNATURE})


def eval_tail(x, weight, bias, labels, ignore_label: int = 255):
    """x (B, C, H, W) float32 or bfloat16 pre-tail activation, weight (C, C, 2, 2) IOHW,
    bias (C,), labels (B, 2H, 2W) uint8 -> see the module docstring.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    add one to ``eval_tail.launches``) or raise."""
    if x.device.type == 'cpu':
        return eval_tail_plain(x, weight, bias, labels, ignore_label)
    if x.device.type != 'cuda':
        raise ValueError("eval_tail runs on CPU or CUDA tensors, got {}".format(x.device))
    _check(x, weight, bias, labels)
    lib = _library()
    fn = lib.dsrl_eval_tail
    b, c, h, w = x.shape
    if c != lib.dsrl_eval_tail_classes() or x.numel() == 0 or not 0 <= ignore_label < 256:
        raise ValueError("eval_tail kernel: needs {} classes, a non-empty batch and an "
                         "ignore label in [0, 256)".format(lib.dsrl_eval_tail_classes()))
    dtype = DTYPE_CODES[x.dtype]
    pred = torch.empty_like(labels)
    ce_sum = torch.empty((), dtype=torch.float64, device=x.device)
    counts = torch.zeros(3 * c + 2, dtype=torch.int64, device=x.device)
    grid = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        err = lib.dsrl_eval_tail_grid(ctypes.c_int(dtype), ctypes.c_longlong(b * h * w),
                                      ctypes.byref(grid))
        if err:
            raise RuntimeError("eval_tail: grid query failed: CUDA error {}".format(err))
        partials = torch.empty(grid.value, dtype=torch.float64, device=x.device)
        err = fn(dtype, x.data_ptr(), weight.data_ptr(), bias.data_ptr(), labels.data_ptr(),
                 pred.data_ptr(), partials.data_ptr(), grid.value, ce_sum.data_ptr(),
                 counts.data_ptr(), b, h, w, ignore_label, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("eval_tail kernel launch failed: CUDA error {}".format(err))
    eval_tail.launches += 1
    # counts: [area_pred (C), area_inter (C), area_target (C), correct, valid]
    areas = (counts[:c], counts[c:2 * c], counts[2 * c:3 * c])
    return pred, ce_sum, areas, (counts[3 * c], counts[3 * c + 1])


eval_tail.launches = 0
