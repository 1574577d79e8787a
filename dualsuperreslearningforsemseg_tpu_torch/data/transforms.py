"""Evaluation input pipeline: uint8 batches on the host -> device tensors.

``make_eval_transform_fn`` is the JAX package's eval transform
(data/augment.py:562-583), the reference val/test pipeline
(train_or_resume.py:156-158): label LUT -> /255 -> normalize -> align-
corners bilinear to the input size (and the output size) for the image,
torch-nearest to the output size for the label.  No randomness.  The
float32 arithmetic is the order in which XLA's CPU compiler runs the JAX
function, so that on the CPU the images are that package's bits (the
`test` command's display images are compared bitwise): ``fma(x, 1/255,
-mean) * (1/std)``, then per axis, H first, ``fma(w1, b, w0 * a)`` for the
two source rows (columns) a and b of each output.

``make_eval_loader`` feeds it through ``torch.utils.data.DataLoader``:
each batch read in a worker process as the train loader reads it (the raw
pair cache, the native batched decode or PIL: data/pipeline.py), uint8 HWC
batches in pinned memory, then one non-blocking copy to the device.  With ``world_size`` ranks it serves rank
``rank``'s shard of the in-order split, the JAX Loader's
(``ShardedSampler(shuffle=False, drop_last=False)``, data/pipeline.py:26-67
there): the split is padded cyclically to a multiple of the world size, so
every rank has the same number of batches, and each pad entry comes with a
valid mask of 0, so no sample is counted twice.
"""

import numpy as np
import torch

from ..ops.resize import _linear_indices_weights
from ..utils.spans import span
from .pipeline import ShardedSampler, _Pairs


def _nearest_indices(in_size: int, out_size: int, device) -> torch.Tensor:
    # torch 'nearest' picks floor(j * in / out), computed in float64 as the
    # JAX package's ops/resize.py does.
    src = np.floor(np.arange(out_size, dtype=np.float64) * (in_size / out_size))
    return torch.as_tensor(np.clip(src, 0, in_size - 1).astype(np.int64), device=device)


def _lerp_resize(x: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    """Align-corners bilinear resize of ``x`` along ``dim``: output j is
    ``fma(w1, b, w0 * a)`` with a, b the source entries at floor and ceil
    of j*(I-1)/(O-1), w1 their distance from a and w0 = 1 - w1 (the order
    of XLA's CPU dot over the JAX package's interpolation matrix)."""
    in_size = x.shape[dim]
    if in_size == out_size:
        return x
    i0, i1, frac = _linear_indices_weights(in_size, out_size)
    shape = [1] * x.dim()
    shape[dim] = out_size
    w0 = torch.from_numpy(1.0 - frac).to(x.device).reshape(shape)
    w1 = torch.from_numpy(frac).to(x.device).reshape(shape)
    a = x.index_select(dim, torch.from_numpy(i0).to(x.device, torch.int64))
    b = x.index_select(dim, torch.from_numpy(i1).to(x.device, torch.int64))
    return torch.addcmul(a * w0, b, w1)


def make_eval_transform_fn(input_hw, output_hw, mean, std, label_lut: np.ndarray):
    """Returns fn(images_u8 (B,H,W,3), segs_u8 (B,H,W)) ->
    ((img_lo, img_hi), (seg_hi, seg)): NHWC float32 images at the input and
    output sizes (views of contiguous NCHW tensors), uint8 train-id labels
    at the output and source sizes."""
    input_hw, output_hw = tuple(input_hw), tuple(output_hw)
    inv_255 = 1.0 / torch.tensor(255.0)                         # float32, as XLA folds it
    inv_std = 1.0 / torch.tensor(std, dtype=torch.float32)

    def resize(img, out_hw):
        return _lerp_resize(_lerp_resize(img, 2, out_hw[0]), 3, out_hw[1]).contiguous()

    def transform(images_u8, segs_u8):
        with span('data.eval_transform', device=True):
            device = images_u8.device
            neg_mean = -torch.as_tensor(mean, dtype=torch.float32, device=device)
            lut = torch.as_tensor(label_lut, dtype=torch.uint8, device=device)
            img = torch.addcmul(neg_mean, images_u8.float(), inv_255.to(device)) * inv_std.to(device)
            img = img.permute(0, 3, 1, 2)
            img_lo = resize(img, input_hw)
            img_hi = resize(img, output_hw)
            seg = lut[segs_u8.long()]
            rows = _nearest_indices(seg.shape[1], output_hw[0], device)
            cols = _nearest_indices(seg.shape[2], output_hw[1], device)
            seg_hi = seg.index_select(1, rows).index_select(2, cols)
            return ((img_lo.permute(0, 2, 3, 1), img_hi.permute(0, 2, 3, 1)), (seg_hi, seg))

    return transform


class _MaskedSamples(_Pairs):
    """A batch of indices -> (images, labels, valid), stacked; a pad entry
    ``-(i + 1)`` (pipeline.ShardedSampler) reads sample i's pair with a
    valid of 0."""

    def __getitems__(self, indices):
        imgs, segs = self.decode([i if i >= 0 else -(i + 1) for i in indices])
        return imgs, segs, np.array([i >= 0 for i in indices], np.float32)


def _collate(batch):
    return tuple(torch.from_numpy(a) for a in batch)


def make_eval_loader(dataset, batch_size: int, num_workers: int, device: torch.device,
                     world_size: int = 1, rank: int = 0):
    """In-order batches of (images_u8 (B,H,W,3), segs_u8 (B,H,W), valid (B,)
    float32) from rank ``rank``'s shard of ``world_size``, the last one
    ragged; ``valid`` is 0 for a pad entry.  Worker processes are spawned,
    never forked: the parent may already hold a CUDA context."""
    order = ShardedSampler(len(dataset), world_size, rank, shuffle=False,
                           drop_last=False).indices_for_epoch(0)
    batches = [[int(i) for i in order[b:b + batch_size]] for b in range(0, len(order), batch_size)]
    return torch.utils.data.DataLoader(
        _MaskedSamples(dataset, num_workers), batch_sampler=batches, num_workers=num_workers,
        collate_fn=_collate, pin_memory=device.type == 'cuda',
        multiprocessing_context='spawn' if num_workers > 0 else None)
