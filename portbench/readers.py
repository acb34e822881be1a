"""The arithmetic the metric readers share. Each `metrics/<metric>.py`
binds one of these to its metric; a reader returns None when its run has
nothing for it to read (no trace, no optimizer span), and the harness then
leaves the metric out."""

from __future__ import annotations

import math
import statistics

from .counts.field import PEAK_BF16


def setup_s(run):
    return run.setup_s


def samples_per_s(run):
    """Samples of every unit enqueued in the window over the window, which
    ends when the device has finished them."""
    return run.window.units * run.samples_per_unit / run.window.seconds


def p95_ms(run):
    """The 95th percentile of the window's unit latencies, nearest rank."""
    lat = sorted(run.window.latencies)
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]


def host_ms(run):
    """Median host milliseconds to enqueue one unit on an empty queue."""
    return None if not run.host_s else 1e3 * statistics.median(run.host_s)


def launches_per_unit(run):
    return None if run.trace is None else run.trace.per_unit("kernels")


def kernels_roofline_pct(run):
    """The unit's least time over the device time of its kernels outside
    the optimizer span."""
    if run.trace is None:
        return None
    t = run.trace.per_unit("kernel_s") - run.trace.per_unit("optimizer_kernel_s")
    return None if t <= 0 else 100.0 * run.work.least_seconds() / t


def optimizer_roofline_pct(run):
    """The optimizer's least time over the device time of the kernels
    launched inside its span."""
    if run.trace is None or run.optimizer_s is None:
        return None
    t = run.trace.per_unit("optimizer_kernel_s")
    return None if t <= 0 else 100.0 * run.optimizer_s / t


def mfu_pct(run):
    """The unit's model FLOPs over the traced window's time a unit at the
    card's bf16 peak."""
    if run.trace is None:
        return None
    return 100.0 * run.work.flops / (run.trace.window_s / run.trace.n_units) / PEAK_BF16


def idle_pct(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
