"""The optimizer: SGD with torch's semantics, the reference's only one
(reference command_handlers/train_or_resume.py:63-66).

``torch.optim.SGD(momentum=m, weight_decay=wd, dampening=0,
nesterov=False)`` is the update of the JAX package's ``train/optim.py``
(:31-42): g <- grad + wd * p; buf <- m * buf + g; p <- p - lr * buf.  The
JAX package starts its buffers at 0, so after step 1 they equal g, which
is where torch starts them.  The learning rate is set on the parameter
group each epoch (models/schedulers.py).

The momentum is saved and restored by parameter name in the JAX package's
layout (``optimizer_state_dict``, ``load_optimizer_state_dict``), so a
checkpoint moves between the two packages; the reference's id-keyed torch
layout loads too.
"""

import torch
from torch import nn


def make_sgd(model: nn.Module, lr: float, momentum: float, weight_decay: float) -> torch.optim.SGD:
    return torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum,
                           weight_decay=weight_decay, dampening=0, nesterov=False)


_BN_BUFFER_SUFFIXES = ('running_mean', 'running_var', 'num_batches_tracked')


def optimizer_state_dict(optimizer: torch.optim.SGD, model: nn.Module, learning_rate: float,
                         momentum: float, weight_decay: float) -> dict:
    """The JAX package's name-keyed optimizer state (train/optim.py:45-55
    there), on the host: ``{'momentum_buffers': {torch name: float32
    array}, 'hyperparameters': {...}}``.

    A parameter with no ``momentum_buffer`` yet (torch creates it at the
    first step) exports zeros, the JAX package's ``sgd_init``: with
    dampening 0, ``m * 0 + g`` is the ``g`` torch's first step stores."""
    return {'momentum_buffers': {k: v.cpu().numpy()
                                 for k, v in momentum_tensors(optimizer, model).items()},
            'hyperparameters': {'learning_rate': learning_rate, 'momentum': momentum,
                                'weight_decay': weight_decay}}


def momentum_tensors(optimizer: torch.optim.SGD, model: nn.Module) -> dict:
    """``{parameter name: momentum buffer}`` on the parameters' device, zeros
    where torch has not created the buffer yet."""
    out = {}
    for name, p in model.named_parameters():
        buf = optimizer.state.get(p, {}).get('momentum_buffer')
        out[name] = torch.zeros_like(p, dtype=torch.float32) if buf is None else buf.detach()
    return out


def _torch_sgd_buffers_by_name(state_dict, model_state_dict):
    """torch SGD's id-keyed ``state`` / ``param_groups`` (the reference saves
    ``optimizer.state_dict()`` as is, reference utils.py:270-282) -> {name:
    buffer}, as the JAX package's ``_torch_sgd_buffers_by_name`` maps it.

    torch numbers the parameters of the reference's single
    ``SGD(model.parameters())`` group in ``named_parameters()`` order: the
    checkpoint's ``model_state_dict`` key order without the BN buffers.
    Ids absent from ``state`` were never stepped and get no buffer."""
    if model_state_dict is None:
        raise ValueError("A torch-format optimizer_state_dict is id-keyed; mapping it to parameter "
                         "names needs the checkpoint's model_state_dict for their order.")
    names = [k for k in model_state_dict if not k.endswith(_BN_BUFFER_SUFFIXES)]
    ids = [pid for group in state_dict['param_groups'] for pid in group['params']]
    if len(ids) != len(names):
        raise ValueError("torch optimizer state covers {} parameters but the checkpoint's "
                         "model_state_dict has {}.".format(len(ids), len(names)))
    state = state_dict['state']
    buffers = {}
    for name, pid in zip(names, ids):
        entry = state.get(pid, state.get(str(pid)))   # a JSON round trip makes the ids strings
        if entry is not None and entry.get('momentum_buffer') is not None:
            buffers[name] = entry['momentum_buffer']
    return buffers


def load_optimizer_state_dict(optimizer: torch.optim.SGD, model: nn.Module, state_dict: dict,
                              model_state_dict=None) -> None:
    """Sets ``optimizer.state[p]['momentum_buffer']`` of ``model``'s
    parameters from a saved optimizer state, on each parameter's device.

    Takes the JAX package's name-keyed layout, strictly (a missing or an
    unknown name raises), and torch SGD's id-keyed ``state`` +
    ``param_groups`` as the reference writes it, whose ids map to names
    through ``model_state_dict`` (the checkpoint's own); ids absent there
    keep torch's lazy first buffer."""
    params = dict(model.named_parameters())
    if 'momentum_buffers' in state_dict:
        buffers = state_dict['momentum_buffers']
        missing = [k for k in params if k not in buffers]
        if missing:
            raise KeyError("optimizer state lacks the buffers of {}".format(missing[:8]))
    elif 'state' in state_dict and 'param_groups' in state_dict:
        buffers = _torch_sgd_buffers_by_name(state_dict, model_state_dict)
    else:
        raise KeyError("Unrecognized optimizer_state_dict layout: expected 'momentum_buffers' or "
                       "'state' + 'param_groups', got keys {}".format(sorted(state_dict)[:8]))
    unknown = [k for k in buffers if k not in params]
    if unknown:
        raise KeyError("optimizer state has buffers for unknown parameters: {}".format(unknown[:8]))
    for name, value in buffers.items():
        p = params[name]
        buf = torch.as_tensor(value)
        if tuple(buf.shape) != tuple(p.shape):
            raise ValueError("Shape mismatch for the momentum of '{}': {} vs {}".format(
                name, tuple(buf.shape), tuple(p.shape)))
        optimizer.state[p]['momentum_buffer'] = buf.to(device=p.device, dtype=p.dtype).clone()
