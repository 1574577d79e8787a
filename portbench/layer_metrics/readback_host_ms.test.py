"""Host milliseconds a frame of the argmax and the wait for the class map on the host
(``test.readback``)."""

from portbench.layer_metrics._spans import ms_per_step


def read(obs):
    return ms_per_step(obs, ('test.readback',), 'host')
