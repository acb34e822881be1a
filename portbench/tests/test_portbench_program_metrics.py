"""The per-layer metrics read from the program's recorder
(`portbench/program.py`): nothing without a trace or without a recorder,
and per traced unit what the recorder holds."""

import json

import pytest

from small import SEED, load_small  # noqa: F401  (the checkout's root on sys.path)
from portbench import harness, spec, trace
from tcnn_tpu_torch.utils import profiling

#: the readers this module holds to account, by cell
TRAIN = ("entry.self_host_ms.train", "kernels.prepare_host_ms.train",
         "kernels.launch_host_ms.train", "optimizer.host_ms.train",
         "kernels.program_launches.train")
INFER = ("entry.self_host_ms.infer", "entry.operands_host_ms.infer",
         "kernels.launch_host_ms.infer", "kernels.program_launches.infer",
         "entry.operand_rebuilds.infer")
N_UNITS = 4


def record(summary):
    return harness.RunRecord(None, 1.0, harness.Window(),
                             {"samples_per_unit": 1, "work": None, "optimizer_s": None},
                             summary, None)


def traced(n=N_UNITS):
    return record(trace.TraceSummary(units=[trace.Unit(kernels=1) for _ in range(n)],
                                     window_s=1e-3, busy_s=5e-4, device_ops=[], idle_gaps=[]))


@pytest.fixture
def filled(monkeypatch):
    """The program's recorder after N_UNITS steps and N_UNITS frames laid
    out as the program opens its spans, on a clock that ticks 1 us a read
    (a span reads it on entry and on exit, so each child takes 1 us and a
    parent 1 us more than the reads inside it), and the launches counted."""
    now = [0]

    def tick():
        now[0] += 1000
        return now[0]

    monkeypatch.setattr(profiling.time, "perf_counter_ns", tick)
    profiling.reset_recorded()
    span, count = profiling.span, profiling.count
    with profiling.recording():
        for _ in range(N_UNITS):
            with span("tcnn.training_step"):                     # 7 us, self 4
                with span("tcnn.k6.prepare"):                    # 1 us
                    pass
                with span("tcnn.k6.launch"):                     # 1 us
                    count("launches.K6")
                with span("tcnn.optimizer.step"):                # 1 us
                    pass
            with span("tcnn.inference"):                         # 7 us, self 4
                with span("tcnn.k3.operands"):                   # 1 us
                    pass
                for _ in range(2):
                    with span("tcnn.k3.launch"):                 # 1 us each
                        count("launches.K3")
        count("k3.operands_rebuilt")
    yield profiling.recorded()
    profiling.reset_recorded()


def read(name, run):
    return spec.load_reader(name).read(run)


@pytest.mark.parametrize("name", TRAIN + INFER)
def test_a_run_without_a_trace_reads_nothing(name, filled):
    assert read(name, record(None)) is None


@pytest.mark.parametrize("name", TRAIN + INFER)
def test_a_program_without_a_recorder_reads_nothing(name, filled, monkeypatch):
    """A program older than the recorder has no `recorded`: its traced
    runs leave these metrics out and raise nothing."""
    monkeypatch.delattr(profiling, "recorded")
    assert read(name, traced()) is None


def test_each_reader_reads_its_span_or_counter_a_traced_unit(filled):
    run = traced()
    spans = filled["spans"]
    assert spans["tcnn.training_step"]["total_s"] == pytest.approx(N_UNITS * 7e-6)
    want = {
        "entry.self_host_ms.train": 4e-3,
        "kernels.prepare_host_ms.train": 1e-3,
        "kernels.launch_host_ms.train": 1e-3,
        "optimizer.host_ms.train": 1e-3,
        "kernels.program_launches.train": 3.0,   # K6 and both K3 launches: the recorder's sum
        "entry.self_host_ms.infer": 4e-3,
        "entry.operands_host_ms.infer": 1e-3,
        "kernels.launch_host_ms.infer": 2e-3,
        "kernels.program_launches.infer": 3.0,
        "entry.operand_rebuilds.infer": 1 / N_UNITS,
    }
    assert {n: read(n, run) for n in TRAIN + INFER} == pytest.approx(want)


def test_counters_read_zero_and_a_missing_span_nothing():
    """A program with a recorder that counted nothing reads 0 (the render
    cell rebuilds no operands); a span it never opened reads None."""
    profiling.reset_recorded()
    run = traced()
    assert read("entry.operand_rebuilds.infer", run) == 0.0
    assert read("kernels.program_launches.train", run) == 0.0
    assert read("optimizer.host_ms.train", run) is None


def test_the_benchmark_names_each_reader_once_in_its_cell():
    assert spec.validate() == []
    bench = json.loads((spec.HERE.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    reports = {m["name"]: set(m.get("workloads", [])) for m in bench["end_to_end"]}
    for names, cell, moves in ((TRAIN, "hash_image.train", "train_samples_per_s"),
                               (INFER, "hash_image.infer", "infer_samples_per_s")):
        for name in names:
            m = entries[name]
            # listed once in each cell, and only in cells that report what it moves
            assert cell in m["workloads"] and len(set(m["workloads"])) == len(m["workloads"])
            assert set(m["workloads"]) <= reports[moves]
            assert m["moves"] == moves and m["better"] == "lower"
            assert m["source"] == ("program_counter" if "launches" in name or "rebuilds" in name
                                   else "program_span")
    # K6's spans: nothing to read on the composed route
    for name in ("kernels.prepare_host_ms.train", "kernels.launch_host_ms.train"):
        assert "oneblob_image.train" not in entries[name]["workloads"]
