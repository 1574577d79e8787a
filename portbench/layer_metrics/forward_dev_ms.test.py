"""Device milliseconds a frame of the network's forward (``test.forward``)."""

from portbench.layer_metrics._spans import ms_per_step


def read(obs):
    return ms_per_step(obs, ('test.forward',), 'device')
