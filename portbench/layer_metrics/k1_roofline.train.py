"""K1 (final ConvT + CE, forward and backward): its bound time over its
device time in the traced window, by kernel name."""

from portbench.layer_metrics._common import k1_roofline as read  # noqa: F401
