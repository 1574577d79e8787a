"""`print-model` command (reference command_handlers/print_model.py:7-11):
layer dump + trainable/total parameter counts.

The dump is ``print(model)`` of ``DSRL(num_classes, stage)``, PyTorch's
module tree, where the JAX package prints flax's ``tabulate`` table; the
counts line is the JAX package's, with the same numbers (parameters only,
no BatchNorm buffers)."""

from ..models import DSRL, count_params
from ..utils import INFO


def print_model(stage, dataset, **other_args):
    """Returns ``(trainable, total)``."""
    model = DSRL(num_classes=dataset['settings'].NUM_CLASSES, stage=stage)
    print(model)
    trainable, total = count_params(model)
    print(INFO("Total training parameters: {0:,}\nTotal parameters: {1:,}".format(trainable, total), prefix='\n'))
    return trainable, total
