"""Device milliseconds a step of ``zero_grad`` and the backward pass (``train.backward``)."""

from portbench.layer_metrics._spans import ms_per_step


def read(obs):
    return ms_per_step(obs, ('train.backward',), 'device')
