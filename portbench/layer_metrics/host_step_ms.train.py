"""Host milliseconds a step of the warp and the train step (``data.warp`` +
``train.step``), the host's waits on the card included."""

from portbench.layer_metrics._spans import ms_per_step


def read(obs):
    return ms_per_step(obs, ('data.warp', 'train.step'), 'host')
