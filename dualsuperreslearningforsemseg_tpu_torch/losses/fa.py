"""Feature-affinity (FA) loss on NCHW feature maps, in float32.

The JAX package's ``losses/fa.py`` (reference models/losses/FALoss.py:8-33):

1. ``AvgPool2d(subsample_factor)`` of both maps (floor semantics);
2. each (batch, channel) slice divided by its matrix 2-norm (the largest
   singular value; the reference's ``torch.linalg.norm(ord=2)``, not the
   Frobenius norm the paper implies), found by 60 rounds of power iteration
   with the JAX package's start vector, not an exact SVD;
3. the column similarity S = M^T M of each (h, w) slice, N = w^2 entries;
4. the mean of |S1_i - S2_j| over all N^2 pairs and all slices.

Step 4 has three forms that compute the same value: ``'dense'`` writes the
pair tensor, ``'sorted'`` is the O(N log N) closed form (one sort and one
search per slice), and ``'kernel'`` is the all-pairs reduction K4
(ops/fa_pairwise.py; its plain version on CPU tensors).  ``'auto'`` takes
the kernel for CUDA tensors at every N, and on the CPU keeps the JAX
package's rule: dense up to slices * N^2 = 256M pair values, sorted above.
Autocast is off inside: the loss always runs in float32.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.fa_pairwise import fa_allpairs_abs_mean, fa_allpairs_abs_sum_rows
from ..utils.spans import span

_DENSE_PAIRS = 256_000_000


def _spectral_norm_hw(x: torch.Tensor, iters: int = 60) -> torch.Tensor:
    """Largest singular value of each (..., h, w) matrix, keepdims on (h, w):
    power iteration on G = A^T A from the start vector 1/sqrt(w) (+0.01 on
    its first entry), then sigma = u^T A v with u and v detached, so its
    gradient is u v^T."""
    a = x.float()
    with torch.no_grad():
        gram = torch.einsum('...hi,...hj->...ij', a, a)
        w = gram.shape[-1]
        v = torch.full(gram.shape[:-2] + (w,), 1.0 / np.sqrt(w), dtype=torch.float32,
                       device=a.device)
        v[..., 0] += 0.01
        for _ in range(iters):
            v = torch.einsum('...ij,...j->...i', gram, v)
            v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(min=1e-30)
        av = torch.einsum('...hi,...i->...h', a, v)
        u = av / torch.linalg.vector_norm(av, dim=-1, keepdim=True).clamp(min=1e-30)
    sigma = torch.einsum('...h,...hi,...i->...', u, a, v)
    return sigma.clamp(min=1e-30)[..., None, None]


def _column_similarity(fm_hw: torch.Tensor) -> torch.Tensor:
    """S = M^T M of each (..., h, w) map -> (..., w, w)."""
    return torch.einsum('...hi,...hj->...ij', fm_hw, fm_hw)


def _allpairs_abs_mean(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mean_{i,j} |a_i - b_j| of each row of (..., N) a and b, in O(N log N):
    with b sorted, prefix sums P and k_i = #{j : b_j <= a_i},
    sum_j |a_i - b_j| = a_i (2 k_i - N) + sum(b) - 2 P[k_i]."""
    n = a.shape[-1]
    bs = torch.sort(b, dim=-1).values
    prefix = torch.cat([bs.new_zeros(bs.shape[:-1] + (1,)), torch.cumsum(bs, -1)], -1)
    k = torch.searchsorted(bs.detach(), a.detach().contiguous(), right=True)
    contrib = a * (2.0 * k.float() - n) + prefix[..., -1:] - 2.0 * prefix.gather(-1, k)
    return contrib.sum(-1) / (n * n)


def _pooled_slices(fm, subsample_factor):
    """(B, C, H, W) -> (B*C, H/s, W/s) float32 average-pooled slices."""
    p = F.avg_pool2d(fm.float(), subsample_factor, subsample_factor)
    return p.reshape(-1, p.shape[2], p.shape[3])


def _similarity_rows(p):
    """(S, h, w) slices -> (S, w*w) rows of their normalised column similarity."""
    s = _column_similarity(p / _spectral_norm_hw(p))
    return s.reshape(s.shape[0], -1)


def _check_maps(fm1, fm2):
    if fm1.dim() != 4 or fm1.shape != fm2.shape:
        raise ValueError("fa_loss: feature maps must both be (B, C, H, W), got {} and {}".format(
            tuple(fm1.shape), tuple(fm2.shape)))


def fa_loss(feature_map1: torch.Tensor, feature_map2: torch.Tensor, subsample_factor: int = 8,
            impl: str = 'auto') -> torch.Tensor:
    """FA loss of two (B, C, H, W) maps: a float32 scalar (reduction 'mean').

    ``impl``: 'dense', 'sorted', 'kernel' or 'auto' (the module docstring)."""
    _check_maps(feature_map1, feature_map2)
    if impl not in ('auto', 'dense', 'sorted', 'kernel'):
        raise ValueError("fa_loss: impl must be auto|dense|sorted|kernel, got {!r}".format(impl))
    with span('losses.fa'), torch.autocast(feature_map1.device.type, enabled=False):
        p1 = _pooled_slices(feature_map1, subsample_factor)
        p2 = _pooled_slices(feature_map2, subsample_factor)
        n_sim = p1.shape[2] * p1.shape[2]
        if impl == 'auto':
            if feature_map1.device.type == 'cuda':
                impl = 'kernel'
            else:
                impl = 'dense' if p1.shape[0] * n_sim * n_sim <= _DENSE_PAIRS else 'sorted'
        s1, s2 = _similarity_rows(p1), _similarity_rows(p2)
        if impl == 'kernel':
            return fa_allpairs_abs_mean(s1, s2)
        if impl == 'dense':
            return (s1[:, :, None] - s2[:, None, :]).abs().mean()
        return _allpairs_abs_mean(s1, s2).mean()


def fa_loss_per_sample(feature_map1: torch.Tensor, feature_map2: torch.Tensor,
                       subsample_factor: int = 8) -> torch.Tensor:
    """(B,) FA loss of each sample alone (the mean over its C slices), from
    the per-row sums of one all-pairs reduction (K4 on CUDA tensors)."""
    _check_maps(feature_map1, feature_map2)
    with span('losses.fa'), torch.autocast(feature_map1.device.type, enabled=False):
        p1 = _pooled_slices(feature_map1, subsample_factor)
        p2 = _pooled_slices(feature_map2, subsample_factor)
        n_sim = p1.shape[2] * p1.shape[2]
        sums = fa_allpairs_abs_sum_rows(_similarity_rows(p1), _similarity_rows(p2))
        return sums.reshape(feature_map1.shape[0], -1).mean(1) / (n_sim * n_sim)


def fa_loss_reference_dense(feature_map1: torch.Tensor, feature_map2: torch.Tensor,
                            subsample_factor: int = 8) -> torch.Tensor:
    """The O(N^2) transcription of the reference reduction, written
    separately from :func:`fa_loss`: the golden model of the tests."""
    with torch.autocast(feature_map1.device.type, enabled=False):
        p1 = F.avg_pool2d(feature_map1.float(), subsample_factor, subsample_factor)
        p2 = F.avg_pool2d(feature_map2.float(), subsample_factor, subsample_factor)
        p1, p2 = p1 / _spectral_norm_hw(p1), p2 / _spectral_norm_hw(p2)
        s1 = torch.einsum('bchi,bchj->bcij', p1, p1)
        s2 = torch.einsum('bchi,bchj->bcij', p2, p2)
        a = s1.reshape(*s1.shape[:2], -1)
        b = s2.reshape(*s2.shape[:2], -1)
        return (a[..., :, None] - b[..., None, :]).abs().mean()
