"""Device milliseconds a step of the input side, from the program's own spans: the warp
(``data.warp``) and the photometric tail with the input resize (``data.post``, K2)."""

from portbench.layer_metrics._spans import ms_per_step


def read(obs):
    return ms_per_step(obs, ('data.warp', 'data.post'), 'device')
