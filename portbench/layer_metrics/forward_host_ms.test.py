"""Host milliseconds a frame of the forward's enqueue at batch 1 (``test.forward``)."""

from portbench.layer_metrics._spans import ms_per_step


def read(obs):
    return ms_per_step(obs, ('test.forward',), 'host')
