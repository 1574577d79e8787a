"""Per-batch metric reductions on the device, the JAX package's
``metrics/device.py`` semantics.

Only the three (C,) histograms and two counts leave the device; the host
metrics (miou.py, accuracy.py) fold them in.  Counts are int64.  A
validation pass over several ranks sums each batch's
:func:`eval_batch_tally` over the ranks (the JAX package's
train_or_resume.py:656-695), so every metric is the global batch's.

``np.histogram(v, bins=C, range=(1, C))`` over the reference's +1-shifted
masked labels (reference metrices/mIoU.py:27-29) puts exactly one integer
value in each bin, so each histogram is a bincount over classes 0..C-1.
"""

import numpy as np
import torch


def argmax_lastdim(x: torch.Tensor) -> torch.Tensor:
    """First maximal index over the last axis, as int64.

    Ties go to the lowest class, like ``torch.argmax``.  A row holding a NaN
    has a NaN maximum that no element equals; such rows give C - 1, as the
    JAX ``argmax_lastdim`` clamps them, where ``torch.argmax`` would point
    at the NaN."""
    n = x.shape[-1]
    m = x.amax(dim=-1, keepdim=True)
    classes = torch.arange(n, device=x.device)
    idx = torch.where(x == m, classes, n).amin(dim=-1)
    return idx.clamp(max=n - 1)


def batch_histograms(pred: torch.Tensor, target: torch.Tensor, num_classes: int,
                     ignore_label: int = 255):
    """(area_pred, area_inter, area_target), each (num_classes,) int64.

    Prediction and intersection count valid-label pixels only; the target
    histogram counts labels in [0, num_classes)."""
    pred = pred.long()
    target = target.long()
    valid = target != ignore_label
    hit = valid & (pred == target)

    def hist(v):
        return torch.bincount(v, minlength=num_classes)[:num_classes]

    return (hist(pred[valid]), hist(pred[hit]),
            hist(target[(target >= 0) & (target < num_classes)]))


def batch_accuracy_counts(pred: torch.Tensor, target: torch.Tensor, ignore_label: int = 255):
    """(correct_pixels, valid_pixels) for the reference Accuracy metric."""
    valid = target.long() != ignore_label
    correct = ((pred.long() == target.long()) & valid).sum()
    return correct, valid.sum()


def eval_batch_tally(losses, hists, acc, n_real):
    """One eval batch as a float64 row whose sum over the ranks is the
    global batch's: the CE sum, the MSE and FA sums, the real samples, the
    correct and valid pixels, then the three histograms.  The sums are the
    eval step's means times their counts, exact in float64 (a float32 times
    an integer below 2^29)."""
    correct, valid = acc
    n_real = n_real.double()
    head = torch.stack([losses['CE'].double() * valid, losses['MSE'].double() * n_real,
                        losses['FA'].double() * n_real, n_real, correct.double(), valid.double()])
    return torch.cat([head] + [h.double() for h in hists])


def eval_batch_results(row, num_classes: int):
    """A (summed) :func:`eval_batch_tally` row, as a numpy float64 array ->
    ((CE, MSE, FA, Total), real samples, (area_pred, area_inter,
    area_target) int64, (correct, valid)).  The means are float32 values
    and Total their float32 sum, so one rank's row gives back the eval
    step's numbers exactly."""
    ce_sum, mse_sum, fa_sum, n_real, correct, valid = row[:6]
    ce = np.float32(ce_sum / valid) if valid > 0 else np.float32(0)
    mse, fa = (np.float32(v / max(n_real, 1.0)) for v in (mse_sum, fa_sum))
    hists = tuple(row[6 + k * num_classes:6 + (k + 1) * num_classes].astype(np.int64)
                  for k in range(3))
    return ((float(ce), float(mse), float(fa), float(ce + mse + fa)), int(n_real), hists,
            (int(correct), int(valid)))
