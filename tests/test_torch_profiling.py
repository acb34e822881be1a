"""The port's profiling utilities (tcnn_tpu_torch/utils/profiling.py) on the
CPU: `StepTimer` counts steps and samples against a fake clock (so no rate
is compared between two reads of a real one), synchronises only when read,
and restarts on `reset`; `trace` writes a torch.profiler trace file that
names the operators run inside it. The recorder's spans and counters, on a
tiny config_hash-like model: off without a profiler or `recording()`, on
in a profiler's active steps only, in the exported trace as often as in
the table, with the parents the program's layers give them."""

import json
import threading

import pytest
import torch

import tcnn_tpu_torch as tt
from tcnn_tpu_torch.utils import profiling
from tcnn_tpu_torch.utils.profiling import StepTimer, trace

#: the program's spans and the span each opens inside
PARENTS = {
    "tcnn.training_step": None,
    "tcnn.k6.prepare": "tcnn.training_step",
    "tcnn.k6.launch": "tcnn.training_step",
    "tcnn.optimizer.step": "tcnn.training_step",
    "tcnn.inference": None,
    "tcnn.k3.operands": "tcnn.inference",
    "tcnn.k3.launch": "tcnn.inference",
}


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


@pytest.fixture
def fit():
    """A config_hash-shaped trainer at a tiny table, on the fused route
    (K6's and K3's twins on the CPU), and a batch; the recorder's table
    empty."""
    cfg = {"loss": {"otype": "RelativeL2"},
           "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
           "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                        "log2_hashmap_size": 8, "base_resolution": 4, "per_level_scale": 1.5},
           "network": {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2}}
    tr = tt.create_from_config(2, 3, cfg, device="cpu").trainer
    assert tr.use_fused()
    gen = torch.Generator().manual_seed(7)
    x, y = torch.rand(256, 2, generator=gen), torch.rand(256, 3, generator=gen)
    profiling.reset_recorded()
    yield tr, x, y
    profiling.reset_recorded()


def _step_and_frame(fit):
    tr, x, y = fit
    tr.training_step(x, y)
    tr.inference(x)


def test_off_span_is_one_object_reads_no_clock_and_records_nothing(fit, monkeypatch):
    assert profiling.span("tcnn.a") is profiling.span("tcnn.b")

    def no_clock():
        raise AssertionError("a span read the clock while off")

    monkeypatch.setattr(profiling.time, "perf_counter_ns", no_clock)
    _step_and_frame(fit)
    assert profiling.recorded() == {"spans": {}, "counters": {}}


def test_profiler_active_steps_record_each_span_as_often_as_the_trace(fit, tmp_path):
    """wait 1, warm-up 1, active 2: the spans open in the two active steps
    only, each in the exported chrome trace as often as in the table."""
    from torch.profiler import ProfilerActivity, profile, schedule

    path = tmp_path / "trace.json"
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=1, warmup=1, active=2, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        for _ in range(4):
            _step_and_frame(fit)
            prof.step()
    _step_and_frame(fit)  # after the schedule: off again
    rec = profiling.recorded()
    assert set(rec["spans"]) == set(PARENTS)
    events = json.loads(path.read_text())["traceEvents"]
    in_trace = {name: sum(1 for e in events if e.get("ph") == "X" and e.get("name") == name)
                for name in PARENTS}
    for name, row in rec["spans"].items():
        assert row["count"] == 2 == in_trace[name], name
        assert row["parent"] == PARENTS[name], name
        assert 0 <= row["self_s"] <= row["total_s"], name
    # one rebuild of K3's operands a step, and no kernel launched on the CPU
    assert rec["counters"] == {"k3.operands_rebuilt": 2}


def test_recording_without_a_profiler_fills_the_table(fit, monkeypatch):
    def no_annotation(name):
        raise AssertionError("record_function opened without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", no_annotation)
    with profiling.recording():
        assert profiling.span("tcnn.a") is not profiling.span("tcnn.a")
        _step_and_frame(fit)
    assert profiling.span("tcnn.a") is profiling.span("tcnn.b")
    _step_and_frame(fit)
    rec = profiling.recorded()
    assert {n: (r["count"], r["parent"]) for n, r in rec["spans"].items()} == {
        n: (1, p) for n, p in PARENTS.items()}
    step = rec["spans"]["tcnn.training_step"]
    children = sum(rec["spans"][n]["total_s"] for n, p in PARENTS.items()
                   if p == "tcnn.training_step")
    assert step["self_s"] == pytest.approx(step["total_s"] - children, abs=1e-6)
    profiling.reset_recorded()
    assert profiling.recorded() == {"spans": {}, "counters": {}}


def test_k3_operands_rebuild_only_after_a_step(fit):
    trainer, x, y = fit
    trainer.inference(x)
    before = profiling.counts()["k3.operands_rebuilt"]
    for _ in range(3):
        trainer.inference(x)
    assert profiling.counts()["k3.operands_rebuilt"] == before
    trainer.training_step(x, y)
    trainer.inference(x)
    trainer.inference(x)
    assert profiling.counts()["k3.operands_rebuilt"] == before + 1


def test_counts_total_with_recording_off_and_reset():
    r = profiling.Recorder()
    r.count("launches.K6")
    r.count("launches.K6", 2)
    r.count("launches.K12")
    r.count("k3.operands_rebuilt")
    assert r.counts("launches.") == {"launches.K6": 3, "launches.K12": 1}
    assert r.counts()["k3.operands_rebuilt"] == 1
    assert r.recorded()["counters"] == {}
    with r.recording():
        r.count("launches.K6")
    assert r.recorded()["counters"] == {"launches.K6": 1}
    assert r.counts("launches.K6") == {"launches.K6": 4}
    r.reset_counts()
    assert r.counts() == {} and r.recorded()["counters"] == {"launches.K6": 1}


def test_self_time_is_the_total_less_the_child_spans(monkeypatch):
    now = [0]

    def tick():
        now[0] += 10
        return now[0]

    monkeypatch.setattr(profiling.time, "perf_counter_ns", tick)
    r = profiling.Recorder()
    with r.recording():
        with r.span("outer"):           # 10 .. 80
            with r.span("inner"):       # 20 .. 30
                pass
            with r.span("inner"):       # 40 .. 70, holding "leaf" 50 .. 60
                with r.span("leaf"):
                    pass
    spans = r.recorded()["spans"]
    assert spans["outer"] == {"count": 1, "total_s": 70e-9, "self_s": pytest.approx(30e-9),
                              "parent": None}
    assert spans["inner"] == {"count": 2, "total_s": 40e-9, "self_s": pytest.approx(30e-9),
                              "parent": "outer"}
    assert spans["leaf"] == {"count": 1, "total_s": 10e-9, "self_s": 10e-9, "parent": "inner"}


def test_spans_on_two_threads_keep_their_own_parents():
    """Two threads open their spans interleaved (a barrier between each
    step), so a stack shared between threads would cross the parents."""
    r = profiling.Recorder()
    barrier = threading.Barrier(2, timeout=10)

    def work(tag):
        with r.span(f"{tag}.outer"):
            barrier.wait()
            with r.span(f"{tag}.inner"):
                barrier.wait()
            barrier.wait()

    with r.recording():
        threads = [threading.Thread(target=work, args=(tag,)) for tag in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    spans = r.recorded()["spans"]
    assert {n: s["parent"] for n, s in spans.items()} == {
        "a.outer": None, "a.inner": "a.outer", "b.outer": None, "b.inner": "b.outer"}


def test_k14_counted_once_a_step_on_the_kernel_route_and_not_on_the_twin(monkeypatch):
    """`launches.K14` counts each launch of the Adam kernel's wrapper (its
    bound C entry point stubbed: the CPU has no card), one a step, with the
    state's tensors as its pointers, every argument its C declaration
    takes, and the versions of what it wrote bumped; the CPU's plain twin
    counts nothing, as K6's twin does."""
    from types import SimpleNamespace

    from tcnn_tpu_torch.ops.cuda import _build, adam_kernel

    opt = tt.create_optimizer({"otype": "Adam", "learning_rate": 1e-2})
    opt.allocate(40, [(4, 5)])
    state, w, g = opt.init_state(device="cpu"), torch.zeros(40), torch.ones(40)
    calls = []
    monkeypatch.setattr(_build, "_entries", {
        "tcnn_adam_step": lambda *args: calls.append(("tcnn_adam_step", args)) or 0})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(adam_kernel, "_counters", {})
    before = profiling.counts("launches.K14").get("launches.K14", 0)
    versions = [t._version for t in (w, *state.values())]
    for _ in range(3):
        adam_kernel.adam_step(opt, state, 128.0, w, g)
    assert profiling.counts("launches.K14")["launches.K14"] == before + 3
    assert [name for name, _ in calls] == ["tcnn_adam_step"] * 3
    args = calls[0][1]
    assert args[:6] == (g.data_ptr(), w.data_ptr(), state["first_moments"].data_ptr(),
                        state["second_moments"].data_ptr(), state["param_steps"].data_ptr(),
                        state["step"].data_ptr())
    assert args[6] is None and len(args) == len(_build.signatures()["tcnn_adam_step"])
    assert args[-1] == 0  # the stream, after the device
    assert all(t._version > v for t, v in zip((w, *state.values()), versions))
    opt.step(state, 128.0, w, g)  # a CPU tensor: the twin
    assert profiling.counts("launches.K14")["launches.K14"] == before + 3 and len(calls) == 3
