"""Kernels a traced step launches, whatever their names (device trace)."""

from portbench.readers import launches_per_unit as read  # noqa: F401
