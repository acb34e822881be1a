"""The arithmetic of the per-layer metrics read from the program's own
recorder, `tcnn_tpu_torch.utils.profiling.recorded()`: the host time of its
spans and its counters.

The recorder is on while a profiler records, that is in the traced run's
active units, which are the units the trace holds; set-up, the warm-up, the
host probe and the reference run outside them. So a reader divides what was
recorded by the trace's unit count. It returns None without a trace (as on
the CPU), and when the program has no recorder or did not open the span.
Host times read under the profiler include its cost on the host's calls:
they are upper figures beside `entry.host_ms.*`."""

from __future__ import annotations


def recorded():
    """The program's recorded table, or None when it has no recorder."""
    try:
        from tcnn_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "recorded", None)
    return None if read is None else read()


def _table(run):
    if run.trace is None or not run.trace.n_units:
        return None
    return recorded()


def span_ms(run, name: str, field: str = "total_s"):
    """Milliseconds a traced unit of the span `name`'s `field` ("total_s"
    or "self_s")."""
    table = _table(run)
    row = None if table is None else table["spans"].get(name)
    return None if row is None else 1e3 * row[field] / run.trace.n_units


def counted_per_unit(run, prefix: str):
    """The counters whose names start with `prefix`, summed, a traced unit
    (0 when the program has a recorder and counted none)."""
    table = _table(run)
    if table is None:
        return None
    return sum(n for name, n in table["counters"].items() if name.startswith(prefix)) / run.trace.n_units
