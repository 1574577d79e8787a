"""ASPP head (atrous spatial pyramid pooling), NCHW.

The reference architecture (reference models/modules/ASPP.py:4-44), as the
JAX package's ``models/aspp.py`` builds it: five Conv+BN+ReLU branches — a
1x1, three 3x3 atrous convs at dilations 6/12/18 * rate, and a 1x1 on the
global-average-pooled feature, resized back by align-corners bilinear
(``ops/resize.py``, as the JAX package resizes it) — and a 1x1 fuse conv
over their concat.  Branch names ``branches.{i}.{0,1}``
are the torch Sequential indices the ``.weights`` files use.
"""

import torch
from torch import nn

from ..ops.resize import resize_bilinear_matmul


def _branch(in_channels, out_channels, kernel, dilation):
    padding = 0 if kernel == 1 else dilation
    return nn.Sequential(
        nn.Conv2d(in_channels, out_channels, kernel, padding=padding,
                  dilation=dilation, bias=False),
        nn.BatchNorm2d(out_channels),
        nn.ReLU(inplace=True))


class ASPP(nn.Module):
    def __init__(self, in_channels: int = 2048, out_channels: int = 256, rate: int = 1):
        super().__init__()
        self.branches = nn.ModuleList(
            [_branch(in_channels, out_channels, 1, 1)]
            + [_branch(in_channels, out_channels, 3, d * rate) for d in (6, 12, 18)]
            + [_branch(in_channels, out_channels, 1, 1),
               _branch(5 * out_channels, out_channels, 1, 1)])

    def forward(self, x):
        outputs = [branch(x) for branch in self.branches[:4]]
        g = self.branches[4](x.mean(dim=(2, 3), keepdim=True))
        outputs.append(resize_bilinear_matmul(g, x.shape[2:]))
        return self.branches[5](torch.cat(outputs, dim=1))
