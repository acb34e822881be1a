"""Host ms to enqueue a training step on an empty queue, median (host clock)."""

from portbench.readers import host_ms as read  # noqa: F401
