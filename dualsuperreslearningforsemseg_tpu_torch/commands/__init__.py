"""One handler per CLI subcommand; ``__main__`` dispatches by the
subcommand's name with dashes as underscores (``purne-weights`` to
``prune_weights``)."""

from .benchmark import benchmark
from .compile_model import compile_model
from .edit_checkpoint import edit_checkpoint
from .inspect_checkpoint import inspect_checkpoint
from .print_model import print_model
from .prune_weights import prune_weights
from .test import test
from .train_or_resume import train_or_resume

__all__ = ['benchmark', 'compile_model', 'edit_checkpoint', 'inspect_checkpoint', 'print_model',
           'prune_weights', 'test', 'train_or_resume']
