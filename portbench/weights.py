"""Seeded weights, made on the device in two draws and handed to the
program and to the reference alike.

A plan walks the reference model's modules in order and asks each for its
own parameters and buffers by rules: first the model module's
``weight_rules(cfg)``, then the defaults here.  Every convolution and
transposed convolution takes Kaiming-normal weights (fan-out mode, ReLU
gain: std sqrt(2 / fan_out), with torch's fan rule of ``dim 0 * receptive
field``) and, where it has one, a bias from U(+-1/sqrt(fan_in)); every
BatchNorm takes weight 1, bias 0, running mean 0 and running variance 1;
every Linear a normal weight of std 0.02 and bias 0; every LayerNorm and
GroupNorm weight 1 and bias 0.  A parameter or buffer that no rule covers
is refused by name when the plan is made.  The normal draws of all weights
come from one ``randn`` and the uniform ones from one ``rand``, on the
run's device, from a generator seeded from the run's seed, so one seed
gives the same bits on both sides.

A rule is ``rule(name, module)`` -> the entries of the module's own
parameters and buffers, ``[(local name, kind, shape, value)]``, or None
where it does not apply: kind 'normal' (value = std), 'uniform' (value =
bound) or 'const' (value = (fill, dtype)).
"""

import math

import torch
from torch import nn

from .models import find

F32 = torch.float32


def conv(mod):
    w = mod.weight
    rf = w[0, 0].numel()
    out = [('weight', 'normal', tuple(w.shape), math.sqrt(2.0 / (w.shape[0] * rf)))]
    if mod.bias is not None:
        out.append(('bias', 'uniform', tuple(mod.bias.shape), 1.0 / math.sqrt(w.shape[1] * rf)))
    return out


def batchnorm(mod, gamma=1.0):
    c = (mod.num_features,)
    return [('weight', 'const', c, (gamma, F32)), ('bias', 'const', c, (0.0, F32)),
            ('running_mean', 'const', c, (0.0, F32)), ('running_var', 'const', c, (1.0, F32)),
            ('num_batches_tracked', 'const', (), (0, torch.int64))]


def linear(mod):
    out = [('weight', 'normal', tuple(mod.weight.shape), 0.02)]
    if mod.bias is not None:
        out.append(('bias', 'const', tuple(mod.bias.shape), (0.0, F32)))
    return out


def norm(mod):
    return [(n, 'const', tuple(t.shape), (fill, F32))
            for n, t, fill in (('weight', mod.weight, 1.0), ('bias', mod.bias, 0.0)) if t is not None]


def _by_type(types, entries):
    return lambda name, mod: entries(mod) if isinstance(mod, types) else None


DEFAULT_RULES = (_by_type((nn.Conv2d, nn.ConvTranspose2d), conv), _by_type(nn.BatchNorm2d, batchnorm),
                 _by_type(nn.Linear, linear), _by_type((nn.LayerNorm, nn.GroupNorm), norm))


def reference_on_meta(cfg):
    with torch.device('meta'):
        return find(cfg).reference(cfg)


def _plan(model, rules):
    """[(state-dict name, kind, shape, value)] of ``model``, module by module;
    raises naming what no rule covers."""
    plan = []
    for mod_name, mod in model.named_modules():
        prefix = mod_name + '.' if mod_name else ''
        entries = next((e for e in (rule(mod_name, mod) for rule in rules) if e is not None), [])
        plan += [(prefix + n, kind, shape, value) for n, kind, shape, value in entries]
    names, state = {p[0] for p in plan}, set(model.state_dict())
    if names != state or len(names) != len(plan):
        raise KeyError("no seeding rule covers {}; the rules name {}, which the model lacks".format(
            sorted(state - names), sorted(names - state)))
    return plan


def make_state(cfg, seed: int, device) -> dict:
    """{state-dict name: tensor} on ``device`` for the model of ``cfg``."""
    plan = _plan(reference_on_meta(cfg), list(find(cfg).weight_rules(cfg)) + list(DEFAULT_RULES))
    gen = torch.Generator(device=device).manual_seed(seed)
    state = {}
    for kind, draw in (('normal', torch.randn), ('uniform', torch.rand)):
        items = [p for p in plan if p[1] == kind]
        if not items:
            continue
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
