"""Host milliseconds a frame of building the network input (``test.input``)."""

from portbench.layer_metrics._spans import ms_per_step


def read(obs):
    return ms_per_step(obs, ('test.input',), 'host')
