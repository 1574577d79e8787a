"""K3 (the eval tail): its bound time over its device time in the traced
window, by kernel name."""

from portbench.layer_metrics._common import k3_roofline as read  # noqa: F401
