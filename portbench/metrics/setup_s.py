"""Set-up: process start to the first timed unit (host clock)."""

from portbench.readers import setup_s as read  # noqa: F401
