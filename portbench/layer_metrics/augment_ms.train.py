"""Device milliseconds a step of the input side: the warp and the photometric
tail with the input resize (K2), from CUDA events around their calls."""

from portbench.layer_metrics._common import layer_ms_per_step


def read(obs):
    return layer_ms_per_step(obs, 'augment')
