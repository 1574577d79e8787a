"""The whole step's model FLOPs over the window, as a share of the card's dense bfloat16 peak."""

from portbench.layer_metrics._common import step_mfu as read  # noqa: F401
