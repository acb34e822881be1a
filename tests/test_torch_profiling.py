"""The port's profiling utilities (tcnn_tpu_torch/utils/profiling.py) on the
CPU: `StepTimer` counts steps and samples against a fake clock (so no rate
is compared between two reads of a real one), synchronises only when read,
and restarts on `reset`; `trace` writes a torch.profiler trace file that
names the operators run inside it."""

import json

import pytest
import torch

from tcnn_tpu_torch.utils import profiling
from tcnn_tpu_torch.utils.profiling import StepTimer, trace


@pytest.fixture
def clock(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: now[0])
    return now


def test_step_timer_counts_steps_and_samples(clock):
    t = StepTimer(128)
    for i in range(5):
        assert t.step(torch.ones(4) * i) is not None
        clock[0] += 0.5
    assert t.seconds() == 2.5
    assert t.steps_per_sec == 2.0 and t.samples_per_sec == 256.0
    t.reset()
    assert t.steps_per_sec == 0.0  # no time has passed
    clock[0] += 4.0
    t.step()
    assert t.steps_per_sec == 0.25 and t.samples_per_sec == 32.0


def test_step_timer_synchronises_only_when_read(clock, monkeypatch):
    """On the devices of the last result (found by `_cuda_devices`, faked
    here: the CPU has no card)."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(profiling, "_cuda_devices",
                        lambda result: {cuda} if result == "on the card" else set())
    t = StepTimer(1)
    t.step("on the card")
    t.step("on the card")
    assert synced == []
    clock[0] += 1.0
    assert t.steps_per_sec == 2.0 and synced == [cuda]
    t.step("on the CPU")
    assert t.steps_per_sec == 3.0 and synced == [cuda]


def test_cuda_devices_walks_nested_results():
    cpu = torch.zeros(2)
    assert profiling._cuda_devices(cpu) == set()
    assert profiling._cuda_devices((cpu, [cpu, {"a": cpu}], None, 3)) == set()


def test_trace_writes_a_file_naming_the_ops(tmp_path):
    with trace(str(tmp_path)) as prof:
        a = torch.randn(64, 64)
        (a @ a).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
