"""Synthetic Cityscapes fixtures for tests and ``--dry-run``-style smoke runs
(SURVEY.md §4: the reference has no test fixtures; this is our substitute).

The generated world is LEARNABLE: each image is a grid of 8x8-pixel tiles,
every tile one raw labelId whose RGB color comes from a fixed palette (plus
small noise).  A model that learns the color -> class mapping generalizes to
unseen layouts, so CLI-level tests can assert losses fall and val mIoU
climbs — not merely that the plumbing runs.
"""

import os
import os.path
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image

_TILE = 8
_PALETTE_SEED = 987654  # shared across splits: the color->class mapping IS the task
_NOISE = 10


def _labelid_palette():
    rng = np.random.default_rng(_PALETTE_SEED)
    return rng.integers(0, 256, size=(34, 3), dtype=np.uint8)


def _synthesize_pair(rng, h, w, noise=_NOISE):
    palette = _labelid_palette()
    tiles = rng.integers(0, 34, size=(max(h // _TILE, 1), max(w // _TILE, 1)),
                         dtype=np.uint8)
    seg = np.kron(tiles, np.ones((_TILE, _TILE), np.uint8))[:h, :w]
    if seg.shape != (h, w):  # images smaller than one tile
        seg = np.pad(seg, ((0, h - seg.shape[0]), (0, w - seg.shape[1])), mode='edge')
    img = palette[seg].astype(np.int16)
    img += rng.integers(-noise, noise + 1, size=(h, w, 3), dtype=np.int16)
    img = np.clip(img, 0, 255).astype(np.uint8)
    seg = seg.copy()
    seg[:2, :2] = 0  # a few guaranteed void pixels (labelId 0 -> ignore)
    return img, seg


def make_synthetic_cityscapes_tree(root, split='train', num_images=4,
                                   size_hw=(64, 128), seed=0, noise=_NOISE):
    """Write a miniature Cityscapes-layout tree of learnable PNG pairs.

    ``noise``: per-pixel uniform-noise amplitude.  The default suits the
    learnability tests; throughput benchmarks pass ``noise=1`` so a full-res
    1024x2048 frame PNG-compresses to ~2.2 MB — the size of a real
    Cityscapes leftImg8bit frame — making decode cost representative
    (amplitude ±10 is incompressible and inflates frames to ~4.1 MB).

    The pairs are drawn in order from ``seed`` and PNG-encoded on a thread
    per CPU (PIL's encoder releases the GIL), so the files do not depend on
    the thread count."""
    rng = np.random.default_rng(seed)
    h, w = size_hw
    img_dir = os.path.join(root, 'leftImg8bit', split, 'synthcity')
    seg_dir = os.path.join(root, 'gtFine', split, 'synthcity')
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(seg_dir, exist_ok=True)

    def write(i, img, seg):
        base = 'synthcity_{:06d}_{:06d}'.format(i, i)
        Image.fromarray(img).save(os.path.join(img_dir, base + '_leftImg8bit.png'))
        Image.fromarray(seg).save(os.path.join(seg_dir, base + '_gtFine_labelIds.png'))

    threads = os.cpu_count() or 1
    with ThreadPoolExecutor(threads) as pool:
        for start in range(0, num_images, threads):   # at most `threads` pairs held at once
            jobs = [pool.submit(write, i, *_synthesize_pair(rng, h, w, noise=noise))
                    for i in range(start, min(start + threads, num_images))]
            for job in jobs:
                job.result()
    return root

