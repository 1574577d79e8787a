"""The weight carrier: the JAX package's variables -> the port's state dict,
and a checked ``load_state_dict`` for flat torch-named dictionaries.

The JAX package names its flax modules after the torch module tree, so the
mapping is mechanical (it mirrors that package's ``models/state_dict.py``
without importing it):

* flax conv ``kernel`` leaves (HWIO) -> torch ``weight`` (OIHW);
* ConvTranspose weights are stored IOHW already, ``nn.ConvTranspose2d``'s
  own layout;
* BatchNorm leaves are torch-named already (weight/bias/running_mean/
  running_var/num_batches_tracked), the running stats in ``batch_stats``.
"""

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn


def _walk(tree, prefix, out):
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, dict):
            _walk(value, path, out)
        else:
            out[path] = value


def port_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` as nested dicts of arrays ->
    the flat torch state dict the port's modules load."""
    flat = {}
    _walk(variables.get('params', {}), '', flat)
    _walk(variables.get('batch_stats', {}), '', flat)
    out = {}
    for key, value in flat.items():
        arr = np.asarray(value)
        if key.endswith('.kernel'):
            key, arr = key[:-len('.kernel')] + '.weight', np.transpose(arr, (3, 2, 0, 1))
        elif key.endswith('num_batches_tracked'):
            arr = arr.astype(np.int64)
        out[key] = torch.from_numpy(np.array(arr))   # a writable, contiguous copy
    return out


def load_state_dict(model: nn.Module, flat: Dict, strict: bool = True
                    ) -> Tuple[List[str], List[str]]:
    """Load a flat torch-named dict of numpy arrays or tensors into ``model``.

    Returns ``(missing_keys, unexpected_keys)``, torch's contract; with
    ``strict=True`` either list being non-empty raises.  A shape mismatch
    raises always.
    """
    own = model.state_dict()
    unexpected = [k for k in flat if k not in own]
    missing = [k for k in own if k not in flat]
    if strict and (missing or unexpected):
        raise KeyError("load_state_dict strict mismatch: missing={} unexpected={}".format(
            missing[:8], unexpected[:8]))
    tensors = {}
    for key, target in own.items():
        if key not in flat:
            continue
        src = torch.as_tensor(flat[key])
        if tuple(src.shape) != tuple(target.shape):
            raise ValueError("Shape mismatch for '{}': checkpoint {} vs model {}".format(
                key, tuple(src.shape), tuple(target.shape)))
        tensors[key] = src.to(target.dtype)
    model.load_state_dict(tensors, strict=False)
    return missing, unexpected


def count_params(model: nn.Module) -> Tuple[int, int]:
    """(trainable, total) parameter counts: ``model.parameters()`` only, BN
    buffers excluded (reference utils.py:262-268, the JAX package's
    ``count_params``)."""
    params = list(model.parameters())
    return (sum(p.numel() for p in params if p.requires_grad),
            sum(p.numel() for p in params))
