"""A frame's model FLOPs over the traced window's time a frame at 989 TFLOP/s (device trace)."""

from portbench.readers import mfu_pct as read  # noqa: F401
