"""A frame's least time over its kernels' device time (device trace)."""

from portbench.readers import kernels_roofline_pct as read  # noqa: F401
