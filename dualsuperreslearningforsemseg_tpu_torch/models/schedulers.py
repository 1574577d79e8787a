"""Learning-rate schedules.

PolynomialLR with the reference's semantics (reference
models/schedulers/PolynomialLR.py:6-34), a copy of the JAX package's
``models/schedulers.py``: stepped once per epoch; ``lr(epoch <= 0) =
base_lr`` (torch's ``_LRScheduler`` returns the base rates until the first
step), then ``(base - end) * (1 - last_epoch / max_steps)^power + end``.  A
plain host object: the train step sets the current rate on the optimizer's
parameter group each epoch.
"""


class PolynomialLR:
    def __init__(self, base_lr, max_decay_steps, end_learning_rate, power, last_epoch=-1):
        self.base_lr = float(base_lr)
        self.max_decay_steps = max_decay_steps
        self.end_learning_rate = float(end_learning_rate)
        self.power = float(power)
        self.last_epoch = last_epoch
        self.step()  # torch _LRScheduler steps once at construction -> last_epoch += 1

    def _calc_poly_decayed_lr(self, initial_lr):
        return (initial_lr - self.end_learning_rate) \
            * ((1.0 - self.last_epoch / self.max_decay_steps) ** self.power) \
            + self.end_learning_rate

    def get_last_lr(self):
        if self.last_epoch > 0:
            return [self._calc_poly_decayed_lr(self.base_lr)]
        return [self.base_lr]

    def step(self):
        self.last_epoch += 1
