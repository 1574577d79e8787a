"""Cross-rank BatchNorm: training-mode statistics over the global batch.

The JAX package's data-parallel step normalises over the global batch
(tests/test_sharded_equivalence.py there; ``TorchBatchNorm(axis_name=...)``,
models/norm.py:103-128 there, is the same reduction spelled out).  In the
port every rank holds its share of that batch, so :class:`CrossRankBatchNorm2d`
all-reduces, per channel, the sum, the sum of squares and the element count,
and takes ``mean = S / n`` and ``var = max(E[x^2] - mean^2, 0)`` over the
global ``n``; the running variance takes the unbiased ``var * n / (n - 1)``
with that ``n``, as ``nn.BatchNorm2d`` on the concatenated batch does.  The
backward all-reduces the two per-channel sums the input gradient needs,
``sum(dy)`` and ``sum(dy * (x - mean))``; the weight and bias gradients stay
local, and ``DistributedDataParallel`` averages them as it does every
parameter's.

Each rank computes its own moments with ``torch.var_mean`` (float32) and
sends ``n_r * mean_r`` and ``n_r * (var_r + mean_r^2)`` in float64, so the
difference ``E[x^2] - mean^2`` is taken in float64.  Only ``all_reduce`` is
used, which gloo (CPU and CUDA tensors) and NCCL both serve:
``nn.SyncBatchNorm`` refuses CPU tensors and gathers its statistics with
``all_gather``.

:func:`convert_sync_batchnorm` swaps the modules in place.  In eval mode
(validation, ``--freeze-batch-norm``), or without a process group of more
than one rank, the module is ``nn.BatchNorm2d`` and communicates nothing.
"""

import torch
import torch.distributed as dist
from torch import nn

_DIMS = (0, 2, 3)


def _all_reduce(t):
    dist.all_reduce(t)
    return t


class _CrossRankBatchNorm(torch.autograd.Function):
    """y = (x - mean) * rsqrt(var + eps) * weight + bias with the global
    batch's mean and biased var; returns (y, mean, var, global n)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        xf = x.float()
        var_r, mean_r = torch.var_mean(xf, dim=_DIMS, unbiased=False)
        n_r = x.numel() // x.shape[1]
        mean_r64 = mean_r.double()
        stats = torch.cat([mean_r64 * n_r, (var_r.double() + mean_r64 * mean_r64) * n_r,
                           torch.full((1,), float(n_r), dtype=torch.float64, device=x.device)])
        stats = _all_reduce(stats)
        c = x.shape[1]
        n = stats[2 * c]
        mean64 = stats[:c] / n
        var = (stats[c:2 * c] / n - mean64 * mean64).clamp(min=0).float()
        mean = mean64.float()
        invstd = torch.rsqrt(var + eps)
        shape = (1, c, 1, 1)
        y = ((xf - mean.reshape(shape)) * (invstd * weight).reshape(shape)
             + bias.reshape(shape)).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.n = n
        ctx.mark_non_differentiable(mean, var, n)
        return y, mean, var, n

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dn):
        x, weight, mean, invstd = ctx.saved_tensors
        shape = (1, x.shape[1], 1, 1)
        dyf = dy.float()
        xmu = x.float() - mean.reshape(shape)
        sum_dy = dyf.sum(dim=_DIMS)
        sum_dy_xmu = (dyf * xmu).sum(dim=_DIMS)
        dweight = sum_dy_xmu * invstd
        dbias = sum_dy
        sums = _all_reduce(torch.stack([sum_dy, sum_dy_xmu]).double())
        n = ctx.n.double()
        mean_dy = (sums[0] / n).float().reshape(shape)
        mean_dy_xmu = (sums[1] / n).float().reshape(shape)
        inv = invstd.reshape(shape)
        dx = (dyf - mean_dy - xmu * (inv * inv) * mean_dy_xmu) * (inv * weight.reshape(shape))
        return dx.to(x.dtype), dweight, dbias, None


class CrossRankBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode statistics span every rank of
    the process group; the same parameters, buffers and state-dict names."""

    def forward(self, x):
        if not (self.training and dist.is_initialized()
                and dist.get_world_size() > 1):
            return super().forward(x)
        if not (self.affine and self.track_running_stats):
            raise ValueError("CrossRankBatchNorm2d needs affine=True and running statistics")
        y, mean, var, n = _CrossRankBatchNorm.apply(x, self.weight, self.bias, self.eps)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            m = (1.0 / float(self.num_batches_tracked)) if self.momentum is None else self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var * (n / (n - 1).clamp(min=1)).float(), alpha=m)
        return y


def convert_sync_batchnorm(model: nn.Module) -> nn.Module:
    """Swaps every ``nn.BatchNorm2d`` of ``model`` for a
    :class:`CrossRankBatchNorm2d` holding the same parameter and buffer
    tensors (an optimizer built before keeps working, attribute paths and
    state-dict names stay), in place; returns ``model``.  Without a process
    group of more than one rank nothing is swapped."""
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return model
    for module in list(model.modules()):
        for name, child in module.named_children():
            if type(child) is nn.BatchNorm2d:
                swapped = CrossRankBatchNorm2d(child.num_features, child.eps, child.momentum,
                                               child.affine, child.track_running_stats)
                swapped.weight, swapped.bias = child.weight, child.bias
                swapped.running_mean, swapped.running_var = child.running_mean, child.running_var
                swapped.num_batches_tracked = child.num_batches_tracked
                setattr(module, name, swapped.train(child.training))
    return model
