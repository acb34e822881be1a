"""Field queries completed over the whole window (host clock)."""

from portbench.readers import samples_per_s as read  # noqa: F401
