"""The optimizer: SGD with torch's semantics, the reference's only one
(reference command_handlers/train_or_resume.py:63-66).

``torch.optim.SGD(momentum=m, weight_decay=wd, dampening=0,
nesterov=False)`` is the update of the JAX package's ``train/optim.py``
(:31-42): g <- grad + wd * p; buf <- m * buf + g; p <- p - lr * buf.  The
JAX package starts its buffers at 0, so after step 1 they equal g, which
is where torch starts them.  The learning rate is set on the parameter
group each epoch (models/schedulers.py).
"""

import torch
from torch import nn


def make_sgd(model: nn.Module, lr: float, momentum: float, weight_decay: float) -> torch.optim.SGD:
    return torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum,
                           weight_decay=weight_decay, dampening=0, nesterov=False)
