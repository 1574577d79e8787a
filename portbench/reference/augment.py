"""The input transforms, plain PyTorch: the training augmentation, the
evaluation transform and the single-frame input.

Training (the recipe's augmentation): a random affine warp of each frame
and its labels to the output size (rotation within +-degrees about the
centre, a zoom-crop of scale U(min, max), a horizontal flip), bilinear
for the image with 0 outside and a rounding to uint8, nearest for the
labels with 255 outside, then the 34 -> 19 label map; then per frame a
3-tap gaussian blur (reflect padding) with probability blur_p, a grayscale
mix with probability grayscale_p, /255 and the normalisation; the network
input is the align-corners bilinear resize of that image to the input size.

The warp matrices of step k come from numpy's
``default_rng(SeedSequence([seed, 0, k]))`` in the order angle, scale,
crop x, crop y, flip; the photometric draws from a torch generator in the
order blur?, sigma, gray?.  Those are the random streams the run hands the
program, drawn here again.
"""

import numpy as np
import torch
import torch.nn.functional as F

LUMA = (0.299, 0.587, 0.114)


def affine_matrices(rng, n, src_hw, out_hw, aug):
    """(n, 2, 3) float32 maps from output pixel centres to source pixel
    centres."""
    h0, w0 = src_hw
    oh, ow = out_hw
    angle = np.deg2rad(rng.uniform(-aug['degrees'], aug['degrees'], n))
    scale = rng.uniform(aug['min_scale'], aug['max_scale'], n)
    cw, ch = w0 / scale, h0 / scale
    cx0 = rng.uniform(0.0, 1.0, n) * (w0 - cw)
    cy0 = rng.uniform(0.0, 1.0, n) * (h0 - ch)
    flip = rng.random(n) < aug['hflip_p']
    sx, sy = cw / ow, ch / oh
    # Output (x, y) -> crop coordinates (u, v) before the rotation.
    a_u = np.where(flip, -sx, sx)
    b_u = np.where(flip, cx0 + (ow - 0.5) * sx - 0.5, cx0 + 0.5 * sx - 0.5)
    b_v = cy0 + 0.5 * sy - 0.5
    # Rotation about the source centre c: src = c + R (crop - c).
    cx, cy = (w0 - 1) / 2.0, (h0 - 1) / 2.0
    cos, sin = np.cos(angle), np.sin(angle)
    m = np.empty((n, 2, 3), np.float32)
    m[:, 0, 0], m[:, 0, 1] = cos * a_u, -sin * sy
    m[:, 0, 2] = cos * (b_u - cx) - sin * (b_v - cy) + cx
    m[:, 1, 0], m[:, 1, 1] = sin * a_u, cos * sy
    m[:, 1, 2] = sin * (b_u - cx) + cos * (b_v - cy) + cy
    return m


def warp(imgs, labels, mats, out_hw, lut):
    """uint8 (B, H, W, 3) frames and (B, H, W) label ids -> warped uint8
    (B, OH, OW, 3) images and (B, OH, OW) train ids."""
    b, h0, w0 = labels.shape
    oh, ow = out_hw
    dev = imgs.device
    m = torch.as_tensor(mats, device=dev)
    y = torch.arange(oh, device=dev, dtype=torch.float32)[None, :, None]
    x = torch.arange(ow, device=dev, dtype=torch.float32)[None, None, :]
    src_x = m[:, 0, 0, None, None] * x + (m[:, 0, 1, None, None] * y + m[:, 0, 2, None, None])
    src_y = m[:, 1, 0, None, None] * x + (m[:, 1, 1, None, None] * y + m[:, 1, 2, None, None])
    n = torch.arange(b, device=dev)[:, None, None]

    inside = (src_x >= 0) & (src_x <= w0 - 1) & (src_y >= 0) & (src_y <= h0 - 1)
    x0 = src_x.clamp(0, w0 - 1).floor().long()
    y0 = src_y.clamp(0, h0 - 1).floor().long()
    x1, y1 = (x0 + 1).clamp(max=w0 - 1), (y0 + 1).clamp(max=h0 - 1)
    fx = (src_x - x0)[..., None]
    fy = (src_y - y0)[..., None]
    f = imgs.float()
    v = ((1 - fx) * (1 - fy) * f[n, y0, x0] + fx * (1 - fy) * f[n, y0, x1]
         + (1 - fx) * fy * f[n, y1, x0] + fx * fy * f[n, y1, x1])
    img = torch.where(inside[..., None], (v + 0.5).floor(), torch.zeros((), device=dev)).to(torch.uint8)

    xr, yr = (src_x + 0.5).trunc().long(), (src_y + 0.5).trunc().long()
    hit = (xr >= 0) & (xr < w0) & (yr >= 0) & (yr < h0) & (src_x >= -0.5) & (src_y >= -0.5)
    lab = labels[n, yr.clamp(0, h0 - 1), xr.clamp(0, w0 - 1)]
    lab = torch.where(hit, lab, torch.full((), 255, dtype=torch.uint8, device=dev))
    return img, torch.as_tensor(lut, dtype=torch.uint8, device=dev)[lab.long()]


def photometric_draws(generator, b, aug):
    """(taps (B, 3), mix (B, 3, 3)) of one step, drawn from ``generator``."""
    dev = generator.device
    blur = torch.rand(b, generator=generator, device=dev) < aug['blur_p']
    sigma = torch.empty(b, device=dev).uniform_(*aug['blur_sigma'], generator=generator)
    gray = torch.rand(b, generator=generator, device=dev) < aug['grayscale_p']
    k = torch.exp(-torch.tensor([1.0, 0.0, 1.0], device=dev) / (2.0 * sigma[:, None] ** 2))
    taps = torch.where(blur[:, None], k / k.sum(1, keepdim=True),
                       torch.tensor([0.0, 1.0, 0.0], device=dev))
    luma = torch.tensor(LUMA, device=dev)[:, None].expand(3, 3)
    mix = torch.where(gray[:, None, None], luma, torch.eye(3, device=dev))
    return taps, mix


def photometric(imgs_u8, taps, mix, mean, std):
    """uint8 (B, H, W, 3) -> float32 (B, 3, H, W): blur, colour mix [c, d],
    /255, normalisation."""
    x = imgs_u8.permute(0, 3, 1, 2).float()
    t = [taps[:, i, None, None, None] for i in range(3)]
    p = F.pad(x, (0, 0, 1, 1), mode='reflect')
    x = t[0] * p[:, :, :-2] + t[1] * p[:, :, 1:-1] + t[2] * p[:, :, 2:]
    p = F.pad(x, (1, 1, 0, 0), mode='reflect')
    x = t[0] * p[..., :-2] + t[1] * p[..., 1:-1] + t[2] * p[..., 2:]
    x = torch.einsum('bchw,bcd->bdhw', x, mix)
    mean = torch.tensor(mean, device=x.device)[None, :, None, None]
    std = torch.tensor(std, device=x.device)[None, :, None, None]
    return (x / 255.0 - mean) / std


def resize(x, hw):
    return F.interpolate(x, size=tuple(hw), mode='bilinear', align_corners=True)


def normalise(imgs_u8, mean, std):
    """uint8 (B, H, W, 3) -> float32 (B, 3, H, W): /255 and the normalisation."""
    x = imgs_u8.permute(0, 3, 1, 2).float()
    mean = torch.tensor(mean, device=x.device)[None, :, None, None]
    std = torch.tensor(std, device=x.device)[None, :, None, None]
    return (x / 255.0 - mean) / std


def eval_labels(labels, out_hw, lut):
    """(B, H, W) label ids -> (B, OH, OW) train ids: the label map, then
    nearest (source index floor(j * in / out))."""
    lab = torch.as_tensor(lut, dtype=torch.uint8, device=labels.device)[labels.long()]
    rows = (torch.arange(out_hw[0], dtype=torch.float64) * (labels.shape[1] / out_hw[0])).floor().long()
    cols = (torch.arange(out_hw[1], dtype=torch.float64) * (labels.shape[2] / out_hw[1])).floor().long()
    return lab[:, rows.to(lab.device)][:, :, cols.to(lab.device)]
