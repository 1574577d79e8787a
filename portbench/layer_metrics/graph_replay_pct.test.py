"""Share of the frames whose device work was one CUDA graph replay
(``test.replay`` spans over the frames); None where no frame replayed one,
as in a program that runs the frame eagerly."""

from portbench.layer_metrics._spans import window


def read(obs):
    records = window(obs) if obs['steps'] else None
    if records is None:
        return None
    replays = sum(r.name == 'test.replay' for r in records)
    return 100.0 * replays / obs['steps'] if replays else None
