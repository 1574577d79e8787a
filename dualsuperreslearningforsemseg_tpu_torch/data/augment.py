"""Training augmentation: the affine warp and the device photometric tail.

The JAX package's default train input path (data/augment.py there): a
per-batch affine warp (rotation, zoom-crop, h-flip and the resize to the
output size, one bilinear resample for the image and one nearest resample
for the label, with the 34->19 label LUT), then on the device the
photometric tail (3-tap gaussian blur, grayscale, normalisation) through
kernel K2 (ops/augment_post.py) and the resize to the model input.

* :func:`sample_affine_matrices_np` is a copy of the JAX package's: the
  warp matrices of batch ``batch_index`` of ``epoch`` come from
  ``np.random.default_rng(SeedSequence([seed, epoch, batch_index]))``, so
  the port warps with the same matrices as the JAX package.
* :func:`warp_pair_batch` has the semantics of the JAX package's C++ data
  plane (native/dataplane.cpp:525-583), in plain PyTorch on the device of
  its inputs: the JAX package warps on host threads only because gathers
  cost a TPU ~320 ms a step.
* :func:`photometric_params` draws the blur and grayscale decisions of the
  JAX ``_photometric_params`` from a ``torch.Generator``: the same
  distributions, not the same numbers.

ColorJitter stays off, as in the recipe; the pixel-unshuffled ``img_hi``
of stages 2-3 is not ported yet.
"""

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.augment_post import photometric
from .transforms import _nearest_indices

# ITU-R 601 luma mix: torchvision Grayscale's coefficients.
LUMA = (0.299, 0.587, 0.114)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    input_hw: Tuple[int, int] = (256, 512)     # model input (img_lo)
    output_hw: Tuple[int, int] = (512, 1024)   # model output (img_hi / seg)
    degrees: float = 15.0
    min_scale: float = 1.0
    max_scale: float = 3.5
    hflip_p: float = 0.5
    blur_p: float = 0.5
    blur_sigma: Tuple[float, float] = (0.1, 2.0)   # torchvision GaussianBlur default
    grayscale_p: float = 0.1
    mean: Tuple[float, float, float] = (0.28690, 0.32513, 0.28389)
    std: Tuple[float, float, float] = (0.17614, 0.18099, 0.17772)
    ignore_label: int = 255


def sample_affine_matrices_np(rng: np.random.Generator, n: int, src_hw, out_hw,
                              cfg: AugmentConfig) -> np.ndarray:
    """(n, 2, 3) float32 matrices mapping OUTPUT pixel coords to SOURCE
    coords (centre convention), composing h-flip, out->src scaling,
    zoom-crop and rotation about the image centre."""
    h0, w0 = src_hw
    oh, ow = out_hw
    angle = rng.uniform(-cfg.degrees, cfg.degrees, n) * (np.pi / 180.0)
    scale = rng.uniform(cfg.min_scale, cfg.max_scale, n)
    crop_w = w0 / scale
    crop_h = h0 / scale
    crop_x = rng.uniform(0.0, 1.0, n) * (w0 - crop_w)
    crop_y = rng.uniform(0.0, 1.0, n) * (h0 - crop_h)
    flip = rng.random(n) < cfg.hflip_p

    sx_scale = crop_w / ow
    sy_scale = crop_h / oh
    a0 = np.where(flip, -sx_scale, sx_scale)
    b0 = np.where(flip, crop_x + (ow - 0.5) * sx_scale - 0.5,
                  crop_x + 0.5 * sx_scale - 0.5)
    a1 = sy_scale
    b1 = crop_y + 0.5 * sy_scale - 0.5

    cx, cy = (w0 - 1) / 2.0, (h0 - 1) / 2.0
    cos, sin = np.cos(angle), np.sin(angle)
    mats = np.empty((n, 2, 3), np.float32)
    mats[:, 0, 0] = cos * a0
    mats[:, 0, 1] = -sin * a1
    mats[:, 0, 2] = cos * (b0 - cx) - sin * (b1 - cy) + cx
    mats[:, 1, 0] = sin * a0
    mats[:, 1, 1] = cos * a1
    mats[:, 1, 2] = sin * (b0 - cx) + cos * (b1 - cy) + cy
    return mats


def warp_pair_batch(imgs_u8, segs_u8, mats, out_hw, lut=None):
    """Affine-warp a batch: bilinear for the images (fill 0), nearest for the
    labels (fill 255, then ``lut``).

    imgs_u8 (B, H0, W0, 3) and segs_u8 (B, H0, W0) uint8; mats (B, 2, 3)
    float32 mapping output pixel coords to source coords; lut (256,) uint8
    or None.  Returns (B, OH, OW, 3) and (B, OH, OW) uint8 on the inputs'
    device.  Per output pixel, with sx = m00*x + (m01*y + m02) (sy alike) in
    float32, as the C++ data plane computes them:

    * image: inside [0, W0-1] x [0, H0-1] the taps are at int(sx), int(sy)
      and the next column/row (clamped), the weights (1-fx)(1-fy) ... , and
      the value is rounded by ``uint8(v + 0.5)``; outside, 0;
    * label: int(sx + 0.5), int(sy + 0.5) (truncating), taken where
      sx >= -0.5, sy >= -0.5 and the index is inside the image; else 255.
    """
    b, h0, w0 = segs_u8.shape
    oh, ow = out_hw
    dev = imgs_u8.device
    mats = mats.to(device=dev, dtype=torch.float32)
    ys = torch.arange(oh, device=dev, dtype=torch.float32).reshape(1, oh, 1)
    xs = torch.arange(ow, device=dev, dtype=torch.float32).reshape(1, 1, ow)
    m = [mats[:, i, j].reshape(b, 1, 1) for i in range(2) for j in range(3)]
    sx = m[0] * xs + (m[1] * ys + m[2])          # (B, OH, OW)
    sy = m[3] * xs + (m[4] * ys + m[5])
    base = (torch.arange(b, device=dev) * (h0 * w0)).reshape(b, 1, 1)

    inside = (sx >= 0) & (sx <= w0 - 1) & (sy >= 0) & (sy <= h0 - 1)
    x0 = sx.clamp(0, w0 - 1).to(torch.int64)     # truncation = floor inside
    y0 = sy.clamp(0, h0 - 1).to(torch.int64)
    x1 = (x0 + 1).clamp(max=w0 - 1)
    y1 = (y0 + 1).clamp(max=h0 - 1)
    fx = (sx - x0).unsqueeze(-1)
    fy = (sy - y0).unsqueeze(-1)
    flat = imgs_u8.reshape(-1, 3)

    def tap(yy, xx):
        return flat[base + yy * w0 + xx].float()

    v = ((1 - fx) * (1 - fy) * tap(y0, x0) + fx * (1 - fy) * tap(y0, x1)
         + (1 - fx) * fy * tap(y1, x0) + fx * fy * tap(y1, x1))
    img_w = torch.where(inside.unsqueeze(-1), (v + 0.5).to(torch.uint8),
                        torch.zeros((), dtype=torch.uint8, device=dev))

    xr = (sx + 0.5).to(torch.int64)              # truncation toward zero
    yr = (sy + 0.5).to(torch.int64)
    hit = (xr >= 0) & (xr < w0) & (yr >= 0) & (yr < h0) & (sx >= -0.5) & (sy >= -0.5)
    label = segs_u8.reshape(-1)[base + yr.clamp(0, h0 - 1) * w0 + xr.clamp(0, w0 - 1)]
    seg_w = torch.where(hit, label, torch.full((), 255, dtype=torch.uint8, device=dev))
    if lut is not None:
        seg_w = torch.as_tensor(lut, dtype=torch.uint8, device=dev)[seg_w.long()]
    return img_w, seg_w


def make_warp_transform(cfg: AugmentConfig, label_lut: np.ndarray, seed: int):
    """fn(epoch, batch_index, imgs_u8, segs_u8) -> warped (imgs, segs) on the
    inputs' device, with the matrices the JAX package's host warp draws for
    the same (seed, epoch, batch_index) (its single-process stream,
    data/augment.py:337-341)."""
    def transform(epoch, batch_index, imgs_u8, segs_u8):
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, batch_index]))
        mats = torch.from_numpy(sample_affine_matrices_np(
            rng, imgs_u8.shape[0], tuple(imgs_u8.shape[1:3]), cfg.output_hw, cfg))
        if imgs_u8.device.type == 'cuda':
            mats = mats.pin_memory().to(imgs_u8.device, non_blocking=True)
        return warp_pair_batch(imgs_u8, segs_u8, mats, cfg.output_hw, label_lut)

    return transform


def photometric_params(generator: torch.Generator, b: int, cfg: AugmentConfig, std):
    """Per-sample (taps (B, 3), cmat (B, 3, 3), coff (B, 3)) float32 on the
    generator's device: blur with probability ``blur_p`` and sigma in
    U(blur_sigma) as the normalised 3-tap gaussian exp(-x^2 / 2 sigma^2),
    else (0, 1, 0); grayscale with probability ``grayscale_p`` as the luma
    mix in every output channel, else identity; cmat = mix / 255 / std[d];
    coff = -mean / std (the JAX ``_photometric_params``, augment.py:352-369)."""
    dev = generator.device
    std_t = torch.as_tensor(std, dtype=torch.float32, device=dev)
    mean_t = torch.as_tensor(cfg.mean, dtype=torch.float32, device=dev)
    do_blur = torch.rand(b, generator=generator, device=dev) < cfg.blur_p
    sigma = torch.empty(b, device=dev).uniform_(*cfg.blur_sigma, generator=generator)
    x = torch.tensor([-1.0, 0.0, 1.0], device=dev)
    g = torch.exp(-(x ** 2) / (2.0 * sigma.reshape(b, 1) ** 2))
    identity_taps = torch.tensor([0.0, 1.0, 0.0], device=dev)
    taps = torch.where(do_blur.reshape(b, 1), g / g.sum(dim=1, keepdim=True), identity_taps)
    do_gray = torch.rand(b, generator=generator, device=dev) < cfg.grayscale_p
    gray = torch.as_tensor(LUMA, dtype=torch.float32, device=dev).reshape(3, 1).expand(3, 3)
    mix = torch.where(do_gray.reshape(b, 1, 1), gray, torch.eye(3, device=dev))
    cmat = mix * (1.0 / 255.0) / std_t.reshape(1, 1, 3)
    coff = (-mean_t / std_t).expand(b, 3)
    return taps.contiguous(), cmat.contiguous(), coff.contiguous()


def device_post(imgs_w_u8, segs_w_u8, taps, cmat, coff, cfg: AugmentConfig,
                dtype=torch.float32):
    """The photometric tail on given parameters -> ((img_lo, img_hi),
    (seg_hi, seg_lo)), the JAX ``make_device_post_fn`` structure: img_hi is
    K2's planar output and img_lo its align-corners bilinear resize to the
    input size, both as NHWC views in ``dtype``; seg_hi is the warped
    uint8 label and seg_lo its nearest downsample (every other pixel when
    the sizes are exactly 2x)."""
    hi = photometric(imgs_w_u8, taps, cmat, coff, dtype)
    lo = F.interpolate(hi, size=tuple(cfg.input_hw), mode='bilinear', align_corners=True)
    (oh, ow), (ih, iw) = cfg.output_hw, cfg.input_hw
    if oh == 2 * ih and ow == 2 * iw:
        seg_lo = segs_w_u8[:, ::2, ::2]
    else:
        dev = segs_w_u8.device
        seg_lo = segs_w_u8.index_select(1, _nearest_indices(oh, ih, dev)) \
                          .index_select(2, _nearest_indices(ow, iw, dev))
    return (lo.permute(0, 2, 3, 1), hi.permute(0, 2, 3, 1)), (segs_w_u8, seg_lo)


def make_device_post_fn(cfg: AugmentConfig, dtype=torch.float32):
    """Returns fn(imgs_w_u8 (B, OH, OW, 3), segs_w_u8 (B, OH, OW), generator)
    -> ((img_lo, img_hi), (seg_hi, seg_lo)): :func:`photometric_params`
    drawn from ``generator`` (on the images' device), then
    :func:`device_post`."""
    def post(imgs_w_u8, segs_w_u8, generator):
        taps, cmat, coff = photometric_params(generator, imgs_w_u8.shape[0], cfg, cfg.std)
        return device_post(imgs_w_u8, segs_w_u8, taps, cmat, coff, cfg, dtype)

    return post
