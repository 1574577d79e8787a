"""Device milliseconds a batch of the eval tail (``eval.tail``): K3 through the losses."""

from portbench.layer_metrics._spans import ms_per_step


def read(obs):
    return ms_per_step(obs, ('eval.tail',), 'device')
