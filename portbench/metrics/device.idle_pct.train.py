"""The traced window's share in which no device operation ran (device trace)."""

from portbench.readers import idle_pct as read  # noqa: F401
