"""Device milliseconds of the DSRL module's forward a step, from CUDA events on its hooks."""

from portbench.layer_metrics._common import layer_ms_per_step


def read(obs):
    return layer_ms_per_step(obs, 'forward')
