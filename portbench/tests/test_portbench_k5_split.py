"""The per-layer metric kernels.k5_split_per_step.train, read from the
program's recorder (`portbench/program.py`): K5's split-plan calls a traced
step."""

import json

import small  # noqa: F401  (the checkout's root on sys.path)
from portbench import harness, spec, trace
from tcnn_tpu_torch.utils import profiling

N_UNITS = 4


def record(summary):
    return harness.RunRecord(None, 1.0, harness.Window(),
                             {"samples_per_unit": 1, "work": None, "optimizer_s": None},
                             summary, None)


def traced(n=N_UNITS):
    return record(trace.TraceSummary(units=[trace.Unit(kernels=1) for _ in range(n)],
                                     window_s=1e-3, busy_s=5e-4, device_ops=[], idle_gaps=[]))


def read(name, run):
    return spec.load_reader(name).read(run)


def test_k5_split_reads_the_split_plans_calls_a_traced_step(monkeypatch):
    """kernels.k5_split_per_step.train: the recorder's `k5.split` count a
    traced unit, 1.0 where each step's K5 takes its split plan, 0 where the
    program counted none, nothing without a trace or from a program that has
    no split plan (no `mlp_kernel.mlp_bwd_plan`); `launches.*` does not take
    it in. Listed only in oneblob_image.train, the cell whose MLP takes the
    split plan."""
    name = "kernels.k5_split_per_step.train"
    profiling.reset_recorded()
    with profiling.recording():
        for _ in range(N_UNITS):
            with profiling.span("tcnn.training_step"):
                for counter in ("launches.K2", "launches.K5", "k5.split", "launches.K14"):
                    profiling.count(counter)
    run = traced()
    try:
        assert read(name, run) == 1.0
        assert read("kernels.program_launches.train", run) == 3.0
        assert read(name, record(None)) is None
        profiling.reset_recorded()
        assert read(name, run) == 0.0
        from tcnn_tpu_torch.ops.cuda import mlp_kernel
        monkeypatch.delattr(mlp_kernel, "mlp_bwd_plan")
        assert read(name, run) is None
    finally:
        profiling.reset_recorded()
    entry = {m["name"]: m for m in json.loads(
        (spec.HERE.parent / "BENCHMARK.json").read_text())["per_layer"]}[name]
    assert entry["workloads"] == ["oneblob_image.train"]
    assert (entry["source"], entry["layer"], entry["moves"], entry["unit"]) == (
        "program_counter", "kernels", "train_samples_per_s", "launches")
