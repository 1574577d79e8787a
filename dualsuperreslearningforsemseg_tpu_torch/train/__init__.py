from .steps import make_eval_step, make_train_step
from .optim import make_sgd

__all__ = ['make_eval_step', 'make_train_step', 'make_sgd']
