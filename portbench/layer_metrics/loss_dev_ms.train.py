"""Device milliseconds a step of the losses (``train.loss``): K1, the MSE, the FA loss
with K4, and the global loss terms."""

from portbench.layer_metrics._spans import ms_per_step


def read(obs):
    return ms_per_step(obs, ('train.loss',), 'device')
