"""The device photometric tail: per-sample 3-tap blur, folded colour affine
and the cast to the compute dtype, in one pass.

The port of the JAX package's Pallas kernel ``photometric_planar``
(ops/pallas/augment_post.py).  :func:`photometric` launches the
hand-written CUDA kernel ``csrc/augment_post.cu`` for CUDA tensors and runs
:func:`photometric_plain`, the same function in plain PyTorch, for CPU
tensors.  Both read the warped NHWC uint8 batch and write planar
(B, 3, H, W) images and, with ``unshuffle=r``, in the same pass the
pixel-unshuffled image (B, 3*r*r, H/r, W/r), the SISR target's layout at
stages 2 and 3 (the JAX kernel's second output, which Mosaic could not
lower on the TPU).  The kernel fuses away the transpose that the JAX
package makes before its kernel.  No backward: the tail is upstream of
every parameter.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import declare, load_library

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_C_SIGNATURE = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])


def _reflect_neighbours(n: int, device):
    """Index maps of the previous and next row (or column) with torchvision
    reflect padding: -1 reads 1, n reads n - 2."""
    idx = torch.arange(n, device=device)
    prev = torch.where(idx == 0, 1, idx - 1)
    nxt = torch.where(idx == n - 1, n - 2, idx + 1)
    return prev, nxt


def photometric_plain(img_u8, taps, cmat, coff, out_dtype=torch.float32, unshuffle: int = 0):
    """(B, H, W, 3) uint8 -> (B, 3, H, W) ``out_dtype``: vertical taps, then
    horizontal taps, then ``out_d = sum_c cmat[:, c, d] * h_c + coff[:, d]``,
    every product and sum a float32 op of its own, in that order.  With
    ``unshuffle=r`` also ``F.pixel_unshuffle`` of that output by r."""
    img = img_u8.permute(0, 3, 1, 2).float()
    t0, t1, t2 = (taps[:, k].reshape(-1, 1, 1, 1) for k in range(3))
    up, down = _reflect_neighbours(img.shape[2], img.device)
    v = t0 * img[:, :, up] + t1 * img + t2 * img[:, :, down]
    left, right = _reflect_neighbours(img.shape[3], img.device)
    h = t0 * v[..., left] + t1 * v + t2 * v[..., right]
    out = [cmat[:, 0, d].reshape(-1, 1, 1) * h[:, 0] + cmat[:, 1, d].reshape(-1, 1, 1) * h[:, 1]
           + cmat[:, 2, d].reshape(-1, 1, 1) * h[:, 2] + coff[:, d].reshape(-1, 1, 1)
           for d in range(3)]
    out = torch.stack(out, dim=1).to(out_dtype)
    return (out, F.pixel_unshuffle(out, unshuffle)) if unshuffle else out


def _check(img_u8, taps, cmat, coff, out_dtype, unshuffle):
    if img_u8.dim() != 4 or img_u8.shape[3] != 3:
        raise ValueError("photometric: images must be (B, H, W, 3), got {}".format(tuple(img_u8.shape)))
    b, h, w, _ = img_u8.shape
    if h < 2 or w < 2 or b == 0:
        raise ValueError("photometric: needs a non-empty batch of at least 2x2 images, got {}"
                         .format(tuple(img_u8.shape)))
    if unshuffle < 0 or (unshuffle and (h % unshuffle or w % unshuffle)):
        raise ValueError("photometric: unshuffle must be 0 or divide H and W, got {} for {}x{}"
                         .format(unshuffle, h, w))
    if out_dtype not in _OUT_CODES:
        raise ValueError("photometric: out_dtype must be float32 or bfloat16, got {}".format(out_dtype))
    for name, t, dtype, shape in (('images', img_u8, torch.uint8, (b, h, w, 3)),
                                  ('taps', taps, torch.float32, (b, 3)),
                                  ('cmat', cmat, torch.float32, (b, 3, 3)),
                                  ('coff', coff, torch.float32, (b, 3))):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.device != img_u8.device:
            raise ValueError("photometric: {} must be a contiguous {} {} tensor on {}, got {} {} {}"
                             .format(name, dtype, shape, img_u8.device, t.dtype,
                                     tuple(t.shape), t.device))


@functools.lru_cache(maxsize=None)
def _library():
    return declare(load_library('augment_post'), {'dsrl_photometric': _C_SIGNATURE})


def photometric(img_u8, taps, cmat, coff, out_dtype=torch.float32, unshuffle: int = 0):
    """img_u8 (B, H, W, 3) uint8; taps (B, 3) blur taps ((0, 1, 0) = no
    blur); cmat (B, 3, 3) colour matrix [c, d]; coff (B, 3) offset ->
    (B, 3, H, W) ``out_dtype`` (float32 or bfloat16); with ``unshuffle=r``
    the pair (that, its pixel-unshuffled (B, 3*r*r, H/r, W/r)).

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    add one to ``photometric.launches``) or raise."""
    if img_u8.device.type == 'cpu':
        return photometric_plain(img_u8, taps, cmat, coff, out_dtype, unshuffle)
    if img_u8.device.type != 'cuda':
        raise ValueError("photometric runs on CPU or CUDA tensors, got {}".format(img_u8.device))
    _check(img_u8, taps, cmat, coff, out_dtype, unshuffle)
    fn = _library().dsrl_photometric
    b, h, w, _ = img_u8.shape
    out = torch.empty((b, 3, h, w), dtype=out_dtype, device=img_u8.device)
    r = unshuffle
    un = torch.empty((b, 3 * r * r, h // r, w // r) if r else (0,), dtype=out_dtype,
                     device=img_u8.device)
    with torch.cuda.device(img_u8.device):
        err = fn(_OUT_CODES[out_dtype], img_u8.data_ptr(), taps.data_ptr(), cmat.data_ptr(),
                 coff.data_ptr(), out.data_ptr(), un.data_ptr(), r, b, h, w,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("photometric kernel launch failed: CUDA error {}".format(err))
    photometric.launches += 1
    return (out, un) if r else out


photometric.launches = 0
