"""Device milliseconds a batch of the eval transform (``data.eval_transform``)."""

from portbench.layer_metrics._spans import ms_per_step


def read(obs):
    return ms_per_step(obs, ('data.eval_transform',), 'device')
