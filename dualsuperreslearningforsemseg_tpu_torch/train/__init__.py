from .steps import make_eval_step, make_train_step
from .optim import make_sgd, momentum_tensors, optimizer_state_dict, load_optimizer_state_dict

__all__ = ['make_eval_step', 'make_train_step', 'make_sgd', 'momentum_tensors',
           'optimizer_state_dict', 'load_optimizer_state_dict']
