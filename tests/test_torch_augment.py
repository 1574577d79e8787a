"""The port's training augmentation (data/augment.py, data/pipeline.py,
ops/augment_post.py on the CPU) against the JAX package's, on the same
numpy inputs.

* ``photometric_plain`` against the Pallas ``photometric_planar`` in
  interpret mode with the same taps, colour matrices and offsets: float32
  within atol 1e-6 and bit-exact for the identity-taps samples, bfloat16
  within one bfloat16 ulp.
* ``sample_affine_matrices_np`` and ``ShardedSampler`` give the JAX
  package's matrices and orders for the same (seed, epoch, batch) keys.
* ``warp_pair_batch`` against the C++ data plane's warp (where its library
  is built) and against the jnp ``_warp_bilinear``/``_warp_nearest`` on the
  same matrices: the image within 1 level; labels equal except where a
  source coordinate lies at a rounding tie (the jnp warp rounds half to
  even; the C++ interior rounds a 16.16 fixed-point coordinate that drifts
  by up to (OW + 1) * 0.5 / 65536 px).  The count of such pixels is asserted
  small and printed.
* ``device_post`` given the same parameters: img_hi as above, img_lo within
  atol 1e-4 of the JAX composition (the kernel, then the matmul-form
  align-corners resize), seg_lo equal.  The tolerance is torch's: its CPU
  bilinear kernel takes source positions as float32 (in - 1) / (out - 1) * j
  and lands up to 5.6e-5 from a float64 resize of values within +-6, where
  the JAX matmul form stays within 5e-7.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dualsuperreslearningforsemseg_tpu.data import augment as jax_augment
from dualsuperreslearningforsemseg_tpu.data import native as jax_native
from dualsuperreslearningforsemseg_tpu.data.pipeline import ShardedSampler as JaxShardedSampler
from dualsuperreslearningforsemseg_tpu.ops.pallas.augment_post import photometric_planar
from dualsuperreslearningforsemseg_tpu.ops.resize import resize_bilinear_matmul_hw
from dualsuperreslearningforsemseg_tpu_torch.data import (
    AugmentConfig, ShardedSampler, device_post, sample_affine_matrices_np, warp_pair_batch)
from dualsuperreslearningforsemseg_tpu_torch.datasets import cityscapes
from dualsuperreslearningforsemseg_tpu_torch.ops.augment_post import photometric_plain

KEYS = [(54321, 1, 0), (54321, 3, 7), (7, 2, 1)]


def _photometric_inputs(rng, b, h, w):
    img = rng.integers(0, 256, size=(b, h, w, 3)).astype(np.uint8)
    sigma = rng.uniform(0.1, 2.0, size=b)
    g = np.exp(-np.array([1.0, 0.0, 1.0])[None] / (2.0 * sigma[:, None] ** 2))
    taps = (g / g.sum(1, keepdims=True)).astype(np.float32)
    taps[0::2] = [0.0, 1.0, 0.0]                                  # identity taps
    std = np.asarray(cityscapes.STD, np.float32)
    mix = np.broadcast_to(np.eye(3, dtype=np.float32), (b, 3, 3)).copy()
    mix[1] = np.broadcast_to(np.asarray((0.299, 0.587, 0.114), np.float32)[:, None], (3, 3))
    cmat = (mix * np.float32(1.0 / 255.0) / std[None, None, :]).astype(np.float32)
    coff = np.broadcast_to(-np.asarray(cityscapes.MEAN, np.float32) / std, (b, 3)).copy()
    return img, taps, cmat, coff


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_photometric_plain_matches_pallas(rng, dtype):
    img, taps, cmat, coff = _photometric_inputs(rng, 4, 16, 128)
    ref = photometric_planar(jnp.asarray(img.transpose(0, 3, 1, 2)), jnp.asarray(taps),
                             jnp.asarray(cmat), jnp.asarray(coff), out_dtype=getattr(jnp, dtype),
                             interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    got = photometric_plain(*_torch(img, taps, cmat, coff), out_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (4, 3, 16, 128)
    got = got.float().numpy()
    if dtype == 'float32':
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[0::2], ref[0::2])
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert np.all(np.abs(got - ref) <= ulp)


@pytest.mark.parametrize('key', KEYS)
def test_affine_matrices_and_order_match_jax(key):
    seed, epoch, batch_index = key
    cfg, jcfg = AugmentConfig(), jax_augment.AugmentConfig()
    draws = []
    for fn, c in ((sample_affine_matrices_np, cfg), (jax_augment.sample_affine_matrices_np, jcfg)):
        r = np.random.default_rng(np.random.SeedSequence([seed, epoch, batch_index]))
        draws.append(fn(r, 8, (1024, 2048), (512, 1024), c))
    np.testing.assert_array_equal(draws[0], draws[1])
    for n in (24, 2975):
        np.testing.assert_array_equal(
            ShardedSampler(n, seed=seed).indices_for_epoch(epoch),
            JaxShardedSampler(n, seed=seed).indices_for_epoch(epoch))


def _source_coords(mats, oh, ow):
    """sx, sy in float32, computed as the warps compute them."""
    ys = np.arange(oh, dtype=np.float32)[None, :, None]
    xs = np.arange(ow, dtype=np.float32)[None, None, :]
    m = mats.astype(np.float32)
    sx = m[:, 0, 0, None, None] * xs + (m[:, 0, 1, None, None] * ys + m[:, 0, 2, None, None])
    sy = m[:, 1, 0, None, None] * xs + (m[:, 1, 1, None, None] * ys + m[:, 1, 2, None, None])
    return sx, sy


def _near_half(s, eps):
    return np.abs(np.abs(s - np.floor(s)) - 0.5) <= eps


def test_warp_matches_native_and_jnp(rng):
    b, h0, w0, oh, ow = 3, 96, 160, 64, 128
    # Smooth, as camera frames are: the C++ interior quantises the bilinear
    # weights to 1/256, so it stays within 1 level of the exact value only
    # where neighbouring source pixels differ by less than 128 levels.
    yy, xx = np.meshgrid(np.arange(h0), np.arange(w0), indexing='ij')
    wave = 128 + 100 * np.sin(xx[None, :, :, None] / 7.0 + np.arange(3)) \
        * np.cos(yy[None, :, :, None] / 5.0)
    imgs = np.clip(wave + rng.integers(-8, 9, size=(b, h0, w0, 3)), 0, 255).astype(np.uint8)
    segs = rng.integers(0, 34, size=(b, h0, w0)).astype(np.uint8)
    segs[:, 10:20, 30:50] = 255
    r = np.random.default_rng(np.random.SeedSequence([54321, 1, 0]))
    mats = sample_affine_matrices_np(r, b, (h0, w0), (oh, ow), AugmentConfig())
    mats[0] = [[1.0, 0.0, 5.0], [0.0, 1.0, 3.0]]                  # integer shift: exact taps
    lut = cityscapes.LABEL_MAPPING_LUT
    img_w, seg_w = warp_pair_batch(*_torch(imgs, segs, mats), (oh, ow), lut)
    img_w, seg_w = img_w.numpy(), seg_w.numpy()
    assert img_w.dtype == np.uint8 and img_w.shape == (b, oh, ow, 3) and seg_w.shape == (b, oh, ow)
    sx, sy = _source_coords(mats, oh, ow)

    # The jnp warps of the JAX package, on the same matrices.
    img_ref = np.stack([np.asarray(jax_augment._warp_bilinear(
        jnp.asarray(imgs[i], jnp.float32), jnp.asarray(mats[i]), (oh, ow), 0.0)) for i in range(b)])
    seg_ref = lut[np.stack([np.asarray(jax_augment._warp_nearest(
        jnp.asarray(segs[i]), jnp.asarray(mats[i]), (oh, ow), 255)) for i in range(b)])]
    assert np.abs(img_w.astype(np.float32) - img_ref).max() <= 1.0
    np.testing.assert_array_equal(img_w[0], np.round(img_ref[0]).astype(np.uint8))
    ties = _near_half(sx, 0.0) | _near_half(sy, 0.0)
    differ = seg_w != seg_ref
    print("labels differing from the jnp warp: {} of {}, all at exact-half ties ({} tie pixels)"
          .format(int(differ.sum()), differ.size, int(ties.sum())))
    assert not np.any(differ & ~ties)
    assert int(differ.sum()) <= max(1, differ.size // 1000)

    if not jax_native.native_available():
        return   # the C++ data plane is not built here; the jnp comparison above stands
    img_n, seg_n = jax_native.warp_pair_batch(imgs, segs, mats, (oh, ow), lut=lut)
    assert np.abs(img_w.astype(np.int16) - img_n.astype(np.int16)).max() <= 1
    near = _near_half(sx, (ow + 1) * 0.5 / 65536 + 1e-4) | _near_half(sy, (ow + 1) * 0.5 / 65536 + 1e-4)
    differ = seg_w != seg_n
    print("labels differing from the C++ warp: {} of {}, all within its fixed-point drift of a "
          "tie ({} such pixels)".format(int(differ.sum()), differ.size, int(near.sum())))
    assert not np.any(differ & ~near)
    assert int(differ.sum()) <= max(1, differ.size // 1000)


def test_device_post_matches_jax_composition(rng):
    cfg = AugmentConfig(input_hw=(8, 64), output_hw=(16, 128), mean=cityscapes.MEAN,
                        std=cityscapes.STD)
    img, taps, cmat, coff = _photometric_inputs(rng, 4, 16, 128)
    seg = rng.integers(0, 19, size=(4, 16, 128)).astype(np.uint8)
    (img_lo, img_hi), (seg_hi, seg_lo) = device_post(*_torch(img, seg, taps, cmat, coff), cfg)
    assert tuple(img_lo.shape) == (4, 8, 64, 3) and tuple(img_hi.shape) == (4, 16, 128, 3)

    hi = photometric_planar(jnp.asarray(img.transpose(0, 3, 1, 2)), jnp.asarray(taps),
                            jnp.asarray(cmat), jnp.asarray(coff), out_dtype=jnp.float32,
                            interpret=True)
    lo = resize_bilinear_matmul_hw(hi, cfg.input_hw)
    np.testing.assert_allclose(img_hi.numpy(), np.asarray(hi).transpose(0, 2, 3, 1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(img_lo.numpy(), np.asarray(lo).transpose(0, 2, 3, 1), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(seg_hi.numpy(), seg)
    np.testing.assert_array_equal(seg_lo.numpy(), seg[:, ::2, ::2])
