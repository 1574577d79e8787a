"""Device milliseconds a batch of the network's forward in the eval step (``eval.forward``)."""

from portbench.layer_metrics._spans import ms_per_step


def read(obs):
    return ms_per_step(obs, ('eval.forward',), 'device')
