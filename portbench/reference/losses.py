"""The DSRL losses and the evaluation tallies, plain PyTorch, float32.

* CE: the mean over labelled pixels of logsumexp(logits) - logit[label]
  (``nn.CrossEntropyLoss(ignore_index=255)``);
* MSE: the mean of the squared difference of the SISR image and the
  high-resolution input (``nn.MSELoss``);
* FA (feature affinity, the paper's eq. 4 as its code computes it): both
  maps average-pooled by 8, each (h, w) slice divided by its largest
  singular value, S = M^T M of each, then the mean of |S1_i - S2_j| over all
  pairs of entries (i, j);
* the tallies of a class map against labels: per-class areas of the
  prediction, of the intersection and of the target over labelled pixels,
  and the correct and labelled pixel counts.
"""

import torch
import torch.nn.functional as F


def cross_entropy(logits, labels, ignore=255):
    """logits (B, C, H, W), labels (B, H, W) -> (mean CE as a float64 scalar, count)."""
    lab = labels.long()
    valid = lab != ignore
    lse = torch.logsumexp(logits.float(), dim=1)
    picked = logits.float().gather(1, lab.clamp(max=logits.shape[1] - 1).unsqueeze(1)).squeeze(1)
    nll = torch.where(valid, lse - picked, torch.zeros((), device=logits.device))
    count = valid.sum()
    return nll.sum(dtype=torch.float64) / count.clamp(min=1), count


def mse(pred, target):
    d = pred.float() - target.float()
    return (d * d).mean()


def fa(fm1, fm2, factor=8):
    def rows(fm):
        p = F.avg_pool2d(fm.float(), factor, factor)
        p = p / torch.linalg.matrix_norm(p, ord=2)[..., None, None]
        s = p.transpose(-1, -2) @ p
        return s.reshape(-1, s.shape[-1] * s.shape[-1])

    a, b = rows(fm1), rows(fm2)
    return (a[:, :, None] - b[:, None, :]).abs().mean()


def tallies(pred, labels, num_classes, ignore=255):
    """(area_pred, area_inter, area_target) (C,) int64 and (correct, labelled)."""
    pred, lab = pred.long(), labels.long()
    valid = lab != ignore
    hit = valid & (pred == lab)

    def hist(v):
        return torch.bincount(v, minlength=num_classes)[:num_classes]

    areas = (hist(pred[valid]), hist(pred[hit]), hist(lab[(lab >= 0) & (lab < num_classes)]))
    return areas, (int(hit.sum()), int(valid.sum()))
