"""Performance observability (counterpart of ``tcnn_tpu/utils/profiling.py``).

The reference's observability is throughput printouts; here a step timer
with steps/s and samples/s, a `torch.profiler` trace (CPU activity, and
CUDA activity where a card is present) written for TensorBoard's profiler
plugin or chrome://tracing, and the program's own spans and counters.

Spans and counters. The program opens `span(name)` at its layer boundaries
and calls `count(name)` where it launches a kernel. A span is off, one
shared no-op object that reads no clock, unless a `torch.profiler`
records (its active steps only) or a caller opened `recording()`. When on,
it adds its host time to an in-memory table, and while a profiler records
it also opens `torch.profiler.record_function(name)`, so the span sits in
the exported trace beside the kernels, on the profiler's clock. Counters
always add to process totals (`counts`); while on, they also add to the
table. Names the program uses:

  spans     tcnn.training_step, tcnn.k6.prepare, tcnn.k6.launch,
            tcnn.optimizer.step, tcnn.inference, tcnn.k3.operands,
            tcnn.k3.launch; a NeRF step's tcnn.nerf.fields,
            tcnn.nerf.composite, tcnn.nerf.backward (models/nerf.py)
  counters  launches.K1 ... launches.K14 (each kernel's launches),
            k3.operands_rebuilt (K3's operands cast anew), nerf.rays and
            nerf.samples (a NeRF step's rays and samples)
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler


def _cuda_devices(result) -> set:
    """The CUDA devices of the tensors in `result` (a tensor or a nest of
    tuples, lists and dicts of them)."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.device.type == "cuda" else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        return set().union(*(_cuda_devices(r) for r in result))
    return set()


class StepTimer:
    """Throughput meter: count training steps, read `steps_per_sec` /
    `samples_per_sec`. The clock starts at construction or `reset()`, so
    call `reset()` just before the steps to time. `step` never
    synchronises; reading a rate synchronises on the devices of the last
    result passed to `step`, so the time read covers its work."""

    def __init__(self, batch_size: int):
        self.batch_size = int(batch_size)
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0
        self._last = None

    def step(self, result=None):
        """Count one step; pass the step's output to enable sync-on-read."""
        self._steps += 1
        self._last = result
        return result

    def seconds(self) -> float:
        """Seconds since the clock started, once the last result is ready."""
        for device in _cuda_devices(self._last):
            torch.cuda.synchronize(device)
        return time.perf_counter() - self._t0

    @property
    def steps_per_sec(self) -> float:
        dt = self.seconds()
        return self._steps / dt if dt > 0 else 0.0

    @property
    def samples_per_sec(self) -> float:
        dt = self.seconds()
        return self._steps * self.batch_size / dt if dt > 0 else 0.0


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace into `logdir` (one
    ``*.pt.trace.json`` file, written on exit); yields the profiler, whose
    `events()` and `key_averages()` can be read after the block. Synchronise
    inside the block, or the last kernels may end after the trace:

        with tcnn_tpu_torch.utils.profiling.trace("traces") as prof:
            for _ in range(10):
                trainer.training_step(x, y)
            torch.cuda.synchronize()
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


class _Off:
    """The span of a recorder that is off: nothing to record."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("recorder", "name", "parent", "annotation", "child_ns", "t0")

    def __init__(self, recorder, name: str):
        self.recorder = recorder
        self.name = name

    def __enter__(self):
        stack = self.recorder._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.annotation = None
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.child_ns = 0
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        total = time.perf_counter_ns() - self.t0
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.recorder._stack().pop()
        if self.parent is not None:
            self.parent.child_ns += total
        self.recorder._add(self.name, None if self.parent is None else self.parent.name,
                           total, total - self.child_ns)
        return False


class Recorder:
    """Host-time spans and counters (the module's `span`, `count`, ...
    are those of one process-wide recorder). Span stacks are per thread;
    the tables are shared and locked."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._depth = 0          # open `recording()` blocks
        self._totals = {}        # name -> n, always
        self._spans = {}         # name -> [count, total ns, self ns, parent], while on
        self._counters = {}      # name -> n, while on

    def span(self, name: str):
        """A context that records its host time under `name` while on;
        off, the same no-op object every call."""
        if self._depth or _autograd_profiler._is_profiler_enabled:
            return _Span(self, name)
        return _OFF

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to the total of `name` and, while on, to the table's."""
        with self._lock:
            self._totals[name] = self._totals.get(name, 0) + n
            if self._depth or _autograd_profiler._is_profiler_enabled:
                self._counters[name] = self._counters.get(name, 0) + n

    def counts(self, prefix: str = "") -> dict:
        """Totals of every counter whose name starts with `prefix`."""
        with self._lock:
            return {k: v for k, v in self._totals.items() if k.startswith(prefix)}

    def reset_counts(self) -> None:
        with self._lock:
            self._totals.clear()

    @contextlib.contextmanager
    def recording(self):
        """Record without a profiler (spans then open no `record_function`)."""
        with self._lock:
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1

    def recorded(self) -> dict:
        """{"spans": {name: {"count", "total_s", "self_s", "parent"}},
        "counters": {name: n}}: what was recorded while on. A span's self
        time is its total less the time its child spans took; its parent is
        the span it first opened inside, or None."""
        with self._lock:
            spans = {name: {"count": c, "total_s": t * 1e-9, "self_s": s * 1e-9, "parent": p}
                     for name, (c, t, s, p) in self._spans.items()}
            return {"spans": spans, "counters": dict(self._counters)}

    def reset_recorded(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _add(self, name, parent, total_ns, self_ns) -> None:
        with self._lock:
            row = self._spans.get(name)
            if row is None:
                self._spans[name] = [1, total_ns, self_ns, parent]
            else:
                row[0] += 1
                row[1] += total_ns
                row[2] += self_ns


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
counts = RECORDER.counts
reset_counts = RECORDER.reset_counts
recording = RECORDER.recording
recorded = RECORDER.recorded
reset_recorded = RECORDER.reset_recorded
