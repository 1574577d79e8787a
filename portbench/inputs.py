"""Seeded frame pools, made on the run's device and held on the host.

A pool is ``n`` uint8 RGB frames of (H, W, 3) and, where the traffic needs
labels, ``n`` uint8 maps of Cityscapes label ids (0..33) in square blocks
of ``label_block`` pixels, so the 34 -> 19 map leaves regions of classes
and of the ignore label.  On a card the pools land in pinned memory, as a
loader's batches do, so a slice of consecutive frames is one pinned batch.
"""

import torch

from .seeds import POOL, subseed


def _host(t, pinned):
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
    out.copy_(t)
    return out


def frame_pool(seed, n, hw, device, labels=True, label_block=16):
    """(frames (n, H, W, 3) uint8, label ids (n, H, W) uint8 or None) on the host."""
    h, w = hw
    gen = torch.Generator(device=device).manual_seed(subseed(seed, POOL))
    pinned = torch.device(device).type == 'cuda'
    frames = torch.randint(0, 256, (n, h, w, 3), generator=gen, device=device, dtype=torch.uint8)
    frames = _host(frames, pinned)
    if not labels:
        return frames, None
    ids = torch.randint(0, 34, (n, h // label_block, w // label_block), generator=gen,
                        device=device, dtype=torch.uint8)
    ids = ids.repeat_interleave(label_block, 1).repeat_interleave(label_block, 2)
    return frames, _host(ids, pinned)
