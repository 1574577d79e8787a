"""Host milliseconds a step of the FA loss (``losses.fa``): pooling, the power
iteration's launches and K4."""

from portbench.layer_metrics._spans import ms_per_step


def read(obs):
    return ms_per_step(obs, ('losses.fa',), 'host')
