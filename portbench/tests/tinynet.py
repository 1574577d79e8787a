"""A model module that the harness has no file for: a small non-DSRL network
(a strided convolution, a depthwise one, a LayerNorm, a Linear head and a
bare per-class scale), which the tests register as
``portbench.models.tinynet`` to add a model by its own module alone.  Its
program is the plain network itself: the port has no such model."""

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.losses import cross_entropy


class TinyNet(nn.Module):
    def __init__(self, num_classes, width):
        super().__init__()
        self.stem = nn.Conv2d(3, width, 3, stride=2, padding=1)
        self.dw = nn.Conv2d(width, width, 3, padding=1, groups=width, bias=False)
        self.norm = nn.LayerNorm(width)
        self.head = nn.Linear(width, num_classes)
        self.scale = nn.Parameter(torch.ones(num_classes))

    def forward(self, x):
        y = self.norm(self.dw(F.relu(self.stem(x))).permute(0, 2, 3, 1))
        logits = (self.head(y) * self.scale).permute(0, 3, 1, 2)
        return (F.interpolate(logits, scale_factor=4, mode='bilinear', align_corners=True),)


def program_env(cfg):
    return {}


def program(cfg):
    with torch.device('meta'):
        return reference(cfg)


def reference(cfg):
    return TinyNet(cfg['num_classes'], cfg['width'])


def weight_rules(cfg):
    def scale(name, mod):
        return [('scale', 'normal', tuple(mod.scale.shape), 0.1)] if isinstance(mod, TinyNet) else None
    return [scale]


def terms(cfg, outputs, hi, seg):
    return {'CE': cross_entropy(outputs[0], seg)[0].float()}


def logits(outputs):
    return outputs[0]


def tiny(cfg):
    return {'width': 8}
