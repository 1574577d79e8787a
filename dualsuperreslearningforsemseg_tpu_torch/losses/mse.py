"""Mean-squared-error loss, ``torch.nn.MSELoss`` semantics (reference
command_handlers/train_or_resume.py:117,436), as the JAX package's
``losses/mse.py`` computes it: the difference in the operands' dtype, its
square and mean in float32."""

import torch


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    diff = (pred - target).float()
    return (diff * diff).mean()
