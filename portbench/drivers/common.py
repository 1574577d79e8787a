"""What the drivers share: the program's modules, the model built from a
configuration, and the comparison arithmetic."""

import importlib
import time
import types

import torch

from ..models import find

PACKAGE = 'dualsuperreslearningforsemseg_tpu_torch'


def port():
    """The program's modules the drivers call, imported on first use."""
    names = ('data', 'train', 'models', 'settings', 'commands.test', 'utils')
    return types.SimpleNamespace(**{n.replace('commands.', ''): importlib.import_module(PACKAGE + '.' + n)
                                    for n in names})


def port_model(cfg):
    """The program's model of ``cfg`` on the meta device (the weights are
    loaded after), as its model module builds it."""
    return find(cfg).program(cfg)


class Phases:
    """Host seconds of the parts of a set-up, each ended by ``mark(name)``
    after a sync; returns the dict so far."""

    def __init__(self):
        self.t = time.perf_counter()
        self.seconds = {}

    def mark(self, name):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now
        return self.seconds


# What a gap reads where an answer has the wrong shape or an impossible
# class: a finite number, so the result line stays valid JSON.
NO_ANSWER = 1e30


def norms(tensors):
    return torch.stack([torch.linalg.vector_norm(t.double()) for t in tensors]).cpu()


def rel_gap(value, ref):
    return abs(value - ref) / max(abs(ref), 1e-12)


# A leaf whose first gradient in the reference is under this share of the
# median leaf's moves by round-off alone (the comparison leaves it out).
STILL_LEAF = 1e-3


def leaf_gaps(ref, prog, keep):
    """Per leaf |program norm - reference norm| over the larger of the
    reference norm and the median kept leaf's; 0 where not kept."""
    scale = torch.maximum(ref, ref[keep].median())
    return torch.where(keep, (prog - ref).abs() / scale, torch.zeros(()))


def worst_leaf_gaps(ref_grad, grad, ref_update, update):
    """(worst gradient-norm gap, worst update-norm gap, leaves compared, the
    worst leaves' indices): the worst leaf's :func:`leaf_gaps`, over the
    leaves whose first reference gradient is not still."""
    keep = ref_grad >= STILL_LEAF * ref_grad.median()
    g, u = leaf_gaps(ref_grad, grad, keep), leaf_gaps(ref_update, update, keep)
    return float(g.max()), float(u.max()), int(keep.sum()), (int(g.argmax()), int(u.argmax()))
