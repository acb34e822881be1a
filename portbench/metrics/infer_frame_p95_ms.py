"""The 95th percentile of every frame's time in the window, first call to synchronize (host clock)."""

from portbench.readers import p95_ms as read  # noqa: F401
