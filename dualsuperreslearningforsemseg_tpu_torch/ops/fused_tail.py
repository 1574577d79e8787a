"""Fused train tail: final ConvTranspose2d(C, C, 2, 2) + bias + masked CE,
forward and backward, without writing the logits.

The port of the JAX package's Pallas kernel ``convt_cols_ce_sum`` and its
``custom_vjp`` (ops/pallas/fused_tail.py).  :func:`fused_convt2_ce_mean`
is the train step's loss: for CUDA tensors it runs :class:`FusedConvT2CE`,
whose forward launches ``csrc/fused_tail.cu``'s forward kernel
(:func:`fused_tail_forward`) and whose backward launches its backward
kernel (:func:`fused_tail_backward`); for CPU tensors it runs
:func:`fused_convt2_ce_mean_plain`, the same function in plain PyTorch
under autograd.  The kernels take the natural NCHW activation and the
(B, 2H, 2W) uint8 labels, as the eval tail does (ops/eval_tail.py).

Semantics (losses/cross_entropy.py): the mean NLL over pixels whose label
is not ``ignore_label``, 0 when none is; a label in [C, ignore) picks a
logit of 0 and adds its pixel's full logsumexp.  A bfloat16 activation
(``--mixed-precision``) takes the TPU kernel's rounding rule, in the
kernels and in the plain version alike: the weight rounded to bfloat16 for
every product, float32 sums, a float32 bias; in the backward the float32
dlogits rounded to bfloat16 for the dX and dW products, db from the float32
dlogits, and dX rounded to bfloat16.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..losses.cross_entropy import cross_entropy_sum
from ._build import declare, load_library

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # the kernels' dtype argument
_FWD_SIGNATURE = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_BWD_SIGNATURE = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int]
                  + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def tail_logits_plain(x, weight, bias):
    """(B, C, 2H, 2W) float32 logits of the final ConvT by the kernels'
    rounding rule: the weight in x's dtype (bfloat16 for a bfloat16 x, as
    the TPU kernel's ``_tile_logits_t`` casts it), every product and sum in
    float32, the bias added in float32."""
    return F.conv_transpose2d(x.float(), weight.to(x.dtype).float(), bias.float(), stride=2)


class _PlainTailBf16(torch.autograd.Function):
    """(ce_sum, count) of a bfloat16 x in plain PyTorch, with the TPU
    kernel's backward written out (``_bwd_kernel``, fused_tail.py:153-184
    there): dlogits = (softmax - onehot) * scale * valid in float32, rounded
    to bfloat16 for the dX and dW products (float32 sums), db from the
    float32 dlogits, dX rounded to bfloat16.  Autograd through the float32
    logits would keep dlogits in float32."""

    @staticmethod
    def forward(ctx, x, weight, bias, labels, ignore_label):
        logits = tail_logits_plain(x, weight, bias)
        ce_sum, count = cross_entropy_sum(logits.permute(0, 2, 3, 1), labels, ignore_label)
        ctx.save_for_backward(x, weight, bias, labels)
        ctx.ignore_label = ignore_label
        ctx.mark_non_differentiable(count)
        return ce_sum, count

    @staticmethod
    def backward(ctx, g_sum, _g_count):
        x, weight, bias, labels = ctx.saved_tensors
        logits = tail_logits_plain(x, weight, bias)
        e = torch.exp(logits - logits.amax(dim=1, keepdim=True))
        p = e / e.sum(dim=1, keepdim=True)
        classes = torch.arange(logits.shape[1], device=x.device).reshape(1, -1, 1, 1)
        onehot = (classes == labels.long().unsqueeze(1)).float()
        valid = (labels != ctx.ignore_label).unsqueeze(1).float()
        dlogits = (p - onehot) * (g_sum.to(torch.float32) * valid)
        dlb = dlogits.to(x.dtype).float()
        wb = weight.to(x.dtype).float()
        dx = F.conv2d(dlb, wb, stride=2).to(x.dtype)          # the ConvT's adjoint
        b, c, h, w = x.shape
        dw = torch.einsum('bihw,bohkwl->iokl', x.float(), dlb.reshape(b, c, h, 2, w, 2))
        return dx, dw, dlogits.sum(dim=(0, 2, 3)), None, None


def fused_convt2_ce_sum_plain(x, weight, bias, labels, ignore_label: int = 255):
    """The plain PyTorch version: materialises the logits.  Returns (CE sum
    over valid pixels as float64, valid count int64), differentiable in x,
    weight and bias.  A float32 x takes autograd through the logits; a
    bfloat16 x the TPU kernel's rounding rule (:class:`_PlainTailBf16`)."""
    if x.dtype == torch.bfloat16:
        return _PlainTailBf16.apply(x, weight, bias, labels, ignore_label)
    logits = F.conv_transpose2d(x.float(), weight, bias, stride=2).permute(0, 2, 3, 1)
    return cross_entropy_sum(logits, labels, ignore_label)


def _mean(ce_sum, count):
    return torch.where(count > 0, ce_sum / count.clamp(min=1), 0.0).float()


def fused_convt2_ce_mean_plain(x, weight, bias, labels, ignore_label: int = 255):
    """The plain version of :func:`fused_convt2_ce_mean`."""
    return _mean(*fused_convt2_ce_sum_plain(x, weight, bias, labels, ignore_label))


def _check(x, weight, bias, labels, ignore_label):
    if x.dim() != 4:
        raise ValueError("fused tail: x must be (B, C, H, W), got {}".format(tuple(x.shape)))
    b, c, h, w = x.shape
    if weight.shape != (c, c, 2, 2) or bias.shape != (c,):
        raise ValueError("fused tail: weight must be ({0},{0},2,2) and bias ({0},), got {1} and {2}"
                         .format(c, tuple(weight.shape), tuple(bias.shape)))
    if labels.shape != (b, 2 * h, 2 * w):
        raise ValueError("fused tail: labels must be {}, got {}".format((b, 2 * h, 2 * w),
                                                                        tuple(labels.shape)))
    if x.dtype not in DTYPE_CODES:
        raise ValueError("fused tail: x must be float32 or bfloat16, got {}".format(x.dtype))
    for name, t, dtype in (('x', x, x.dtype), ('weight', weight, torch.float32),
                           ('bias', bias, torch.float32), ('labels', labels, torch.uint8)):
        if t.dtype != dtype or not t.is_contiguous() or t.device != x.device:
            raise ValueError("fused tail: {} must be a contiguous {} tensor on {}, got {} {}{}"
                             .format(name, dtype, x.device, t.dtype, t.device,
                                     '' if t.is_contiguous() else ' (not contiguous)'))
    if h * w >= 2 ** 31:
        raise ValueError("fused tail: a sample's plane must hold fewer than 2^31 pixels")
    if labels.data_ptr() % 2:
        raise ValueError("fused tail: labels must start at an even address (2-byte loads)")
    if x.numel() == 0 or not 0 <= ignore_label < 256:
        raise ValueError("fused tail kernel: needs a non-empty batch and an ignore label in [0, 256)")


@functools.lru_cache(maxsize=None)
def _declared_library():
    return declare(load_library('fused_tail'), {'dsrl_fused_tail_fwd': _FWD_SIGNATURE,
                                                'dsrl_fused_tail_bwd': _BWD_SIGNATURE})


def _library(c):
    lib = _declared_library()
    if c != lib.dsrl_fused_tail_classes():
        raise ValueError("fused tail kernel: built for {} classes, got {}".format(
            lib.dsrl_fused_tail_classes(), c))
    return lib


def _grid(query, dtype, npix, which):
    """The kernel's fixed persistent grid for ``npix`` pre-tail pixels on
    the current device (the partials are sized by it)."""
    grid = ctypes.c_int(0)
    err = query(ctypes.c_int(dtype), ctypes.c_longlong(npix), ctypes.byref(grid))
    if err:
        raise RuntimeError("fused tail {}: grid query failed: CUDA error {}".format(which, err))
    return grid.value


def fused_tail_forward(x, weight, bias, labels, ignore_label: int = 255):
    """Launches the forward kernel on CUDA tensors (and adds one to
    ``fused_tail_forward.launches``) -> (ce_sum float64, count int64), both
    0-d device tensors.  No autograd; see :class:`FusedConvT2CE`."""
    _check(x, weight, bias, labels, ignore_label)
    b, c, h, w = x.shape
    lib = _library(c)
    fn = lib.dsrl_fused_tail_fwd
    dtype = DTYPE_CODES[x.dtype]
    with torch.cuda.device(x.device):
        grid = _grid(lib.dsrl_fused_tail_fwd_grid, dtype, b * h * w, 'forward')
        ce_partials = torch.empty(grid, dtype=torch.float64, device=x.device)
        cnt_partials = torch.empty(grid, dtype=torch.int64, device=x.device)
        ce_sum = torch.empty((), dtype=torch.float64, device=x.device)
        count = torch.empty((), dtype=torch.int64, device=x.device)
        err = fn(dtype, x.data_ptr(), weight.data_ptr(), bias.data_ptr(), labels.data_ptr(),
                 ce_partials.data_ptr(), cnt_partials.data_ptr(), grid, ce_sum.data_ptr(),
                 count.data_ptr(), b, h, w, ignore_label, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("fused tail forward kernel launch failed: CUDA error {}".format(err))
    fused_tail_forward.launches += 1
    return ce_sum, count


def fused_tail_backward(x, weight, bias, labels, scale, ignore_label: int = 255):
    """Launches the backward kernel on CUDA tensors (and adds one to
    ``fused_tail_backward.launches``).  ``scale`` is the cotangent of the CE
    sum as a 0-d float32 device tensor.  Returns (dX in x's dtype, dW, db
    float32); two launches on the same inputs give bit-identical results."""
    _check(x, weight, bias, labels, ignore_label)
    if scale.dtype != torch.float32 or scale.numel() != 1 or scale.device != x.device:
        raise ValueError("fused tail backward: scale must be one float32 value on {}".format(x.device))
    b, c, h, w = x.shape
    lib = _library(c)
    fn = lib.dsrl_fused_tail_bwd
    dtype = DTYPE_CODES[x.dtype]
    with torch.cuda.device(x.device):
        grid = _grid(lib.dsrl_fused_tail_bwd_grid, dtype, b * h * w, 'backward')
        partials = torch.empty(grid * lib.dsrl_fused_tail_partial_size(),
                               dtype=torch.float64, device=x.device)
        dx = torch.empty_like(x)
        dw = torch.empty_like(weight)
        db = torch.empty_like(bias)
        scale = scale.contiguous()
        err = fn(dtype, x.data_ptr(), weight.data_ptr(), bias.data_ptr(), labels.data_ptr(),
                 scale.data_ptr(), dx.data_ptr(), partials.data_ptr(), grid,
                 dw.data_ptr(), db.data_ptr(), b, h, w, ignore_label,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("fused tail backward kernel launch failed: CUDA error {}".format(err))
    fused_tail_backward.launches += 1
    return dx, dw, db


fused_tail_forward.launches = 0
fused_tail_backward.launches = 0


class FusedConvT2CE(torch.autograd.Function):
    """(ce_sum, count) of the fused tail on CUDA tensors, with the backward
    kernel as its gradient (the JAX package's ``jax.custom_vjp``).  The
    count is an integer and carries no gradient; the labels get none."""

    @staticmethod
    def forward(ctx, x, weight, bias, labels, ignore_label):
        ce_sum, count = fused_tail_forward(x, weight, bias, labels, ignore_label)
        ctx.save_for_backward(x, weight, bias, labels)
        ctx.ignore_label = ignore_label
        ctx.mark_non_differentiable(count)
        return ce_sum, count

    @staticmethod
    def backward(ctx, g_sum, _g_count):
        x, weight, bias, labels = ctx.saved_tensors
        scale = g_sum.detach().to(torch.float32).reshape(())
        dx, dw, db = fused_tail_backward(x, weight, bias, labels, scale, ctx.ignore_label)
        return dx, dw, db, None, None


def fused_convt2_ce_mean(x, weight, bias, labels, ignore_label: int = 255):
    """Mean CE of ``conv_transpose2d(x, weight, bias, stride=2)`` against
    ``labels`` without writing the logits, as a float32 scalar:
    ``where(count > 0, ce_sum / max(count, 1), 0)`` (fused_tail.py:301-322).
    With every pixel ignored the loss is 0 and its gradients are exactly 0.

    x (B, C, H, W) float32 or bfloat16, contiguous; weight (C, C, 2, 2) and
    bias (C,) float32; labels (B, 2H, 2W) uint8.  CPU tensors take the plain
    version; CUDA tensors launch the kernels or raise."""
    if x.device.type == 'cpu':
        return fused_convt2_ce_mean_plain(x, weight, bias, labels, ignore_label)
    if x.device.type != 'cuda':
        raise ValueError("fused_convt2_ce_mean runs on CPU or CUDA tensors, got {}".format(x.device))
    return _mean(*FusedConvT2CE.apply(x, weight, bias, labels, ignore_label))
