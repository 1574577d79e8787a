"""Seeded weights, made on the device in two draws and handed to the
program and to the reference alike.

Every convolution and transposed convolution takes Kaiming-normal weights
(fan-out mode, ReLU gain: std sqrt(2 / fan_out), with torch's fan rule of
``dim 0 * receptive field``) and, where it has one, a bias from
U(+-1/sqrt(fan_in)); every BatchNorm takes weight 1 (``bn3_gamma`` on the
last BatchNorm of each bottleneck), bias 0, running mean 0 and running
variance 1.  The normal draws of all weights come from one ``randn`` and
the uniform ones from one ``rand``, on the run's device, from a generator
seeded from the run's seed, so one seed gives the same bits on both sides.
"""

import math

import torch
from torch import nn

from .reference.model import DSRL


def reference_on_meta(cfg):
    with torch.device('meta'):
        return DSRL(cfg['num_classes'], cfg['stage'], cfg['backbone_layers'])


def _plan(model, bn3_gamma):
    """[(name, kind, shape, value)]: kind 'normal' (value = std), 'uniform'
    (value = bound) or 'const' (value = fill, dtype)."""
    plan = []
    for mod_name, mod in model.named_modules():
        prefix = mod_name + '.' if mod_name else ''
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            rf = w[0, 0].numel()
            plan.append((prefix + 'weight', 'normal', tuple(w.shape),
                         math.sqrt(2.0 / (w.shape[0] * rf))))
            if mod.bias is not None:
                plan.append((prefix + 'bias', 'uniform', tuple(mod.bias.shape),
                             1.0 / math.sqrt(w.shape[1] * rf)))
        elif isinstance(mod, nn.BatchNorm2d):
            c = (mod.num_features,)
            gamma = bn3_gamma if mod_name.endswith('.bn3') else 1.0
            plan += [(prefix + 'weight', 'const', c, (gamma, torch.float32)),
                     (prefix + 'bias', 'const', c, (0.0, torch.float32)),
                     (prefix + 'running_mean', 'const', c, (0.0, torch.float32)),
                     (prefix + 'running_var', 'const', c, (1.0, torch.float32)),
                     (prefix + 'num_batches_tracked', 'const', (), (0, torch.int64))]
    return plan


def make_state(cfg, seed: int, device) -> dict:
    """{state-dict name: tensor} on ``device`` for the model of ``cfg``."""
    plan = _plan(reference_on_meta(cfg), cfg['bn3_gamma'])
    gen = torch.Generator(device=device).manual_seed(seed)
    state = {}
    for kind, draw in (('normal', torch.randn), ('uniform', torch.rand)):
        items = [p for p in plan if p[1] == kind]
        sizes = [math.prod(p[2]) for p in items]
        flat = draw(sum(sizes), generator=gen, device=device)
        scale = torch.repeat_interleave(
            torch.tensor([p[3] for p in items], device=device),
            torch.tensor(sizes, device=device))
        flat = flat * scale if kind == 'normal' else (flat * 2.0 - 1.0) * scale
        for (name, _, shape, _), part in zip(items, flat.split(sizes)):
            state[name] = part.view(shape)
    for name, _, shape, (fill, dtype) in (p for p in plan if p[1] == 'const'):
        state[name] = torch.full(shape, fill, dtype=dtype, device=device)
    return state


def load_into(model, state):
    """Loads ``state`` into ``model`` (built on the meta device or not),
    strictly: every name on both sides."""
    if any(t.is_meta for t in model.state_dict().values()):
        model.to_empty(device=next(iter(state.values())).device)
    missing, unexpected = model.load_state_dict(state, strict=False)
    if missing or unexpected:
        raise KeyError("weights and model differ: missing {} unexpected {}".format(
            missing[:5], unexpected[:5]))
    return model
