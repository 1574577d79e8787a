"""`inspect-checkpoint` command: print a checkpoint's hyperparameters and
bookkeeping while eliding bulky arrays (reference behavior:
command_handlers/inspect_checkpoint.py:6-24 — tensors appear as bare key
names, strings quoted, nested dicts rendered inline), the JAX package's
``_render``."""

import numpy as np
import torch

from ..checkpoint import load_checkpoint_or_weights


def _render(value):
    """One checkpoint value -> display string, or None to elide (arrays)."""
    if isinstance(value, dict):
        entries = []
        for key, child in value.items():
            rendered = _render(child)
            entries.append(str(key) if rendered is None
                           else '{}: {}'.format(key, rendered))
        return '{{{}}}'.format(', '.join(entries))
    if isinstance(value, (np.ndarray, torch.Tensor, list)):
        return None
    if isinstance(value, str):
        return '"{}"'.format(value)
    return str(value)


def inspect_checkpoint(checkpoint, **other_args):
    print(_render(load_checkpoint_or_weights(checkpoint)))
