"""Performance observability (counterpart of ``tcnn_tpu/utils/profiling.py``).

The reference's observability is throughput printouts; here a step timer
with steps/s and samples/s, and a `torch.profiler` trace (CPU activity, and
CUDA activity where a card is present) written for TensorBoard's profiler
plugin or chrome://tracing.
"""

from __future__ import annotations

import contextlib
import time

import torch


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
