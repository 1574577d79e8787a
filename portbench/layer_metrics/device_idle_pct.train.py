"""Share of the traced window in which no operation ran on the card."""

from portbench.layer_metrics._common import idle_pct as read  # noqa: F401
