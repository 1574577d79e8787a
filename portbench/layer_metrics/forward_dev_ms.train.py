"""Device milliseconds a step of the network's forward in the train step (``train.forward``)."""

from portbench.layer_metrics._spans import ms_per_step


def read(obs):
    return ms_per_step(obs, ('train.forward',), 'device')
