"""Adam's least time over the device time of the kernels inside its span (device trace)."""

from portbench.readers import optimizer_roofline_pct as read  # noqa: F401
