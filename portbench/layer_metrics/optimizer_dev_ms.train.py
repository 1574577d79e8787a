"""Device milliseconds a step of the SGD update (``train.optimizer``)."""

from portbench.layer_metrics._spans import ms_per_step


def read(obs):
    return ms_per_step(obs, ('train.optimizer',), 'device')
