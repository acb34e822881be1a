"""The harness on the CPU at a tiny size, with the look for a card
stubbed: the result line, the import guard, the trace reduction."""

import json
import pathlib
import subprocess
import sys
import time

import pytest

from small import SEED, SMALL, load_small
from portbench import harness, trace

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_cpu_run_loads_no_jax_and_prints_a_result(name, tmp_path):
    """A whole run in a fresh process: the result's keys, `checks` last,
    the cell's end-to-end metrics, and no module whose top-level name is
    jax, jaxlib, flax or tcnn_tpu loaded (tcnn_tpu_torch is compared
    whole, not by its prefix)."""
    cell = load_small(name, tmp_path)
    code = f"""
import json, pathlib, sys, time
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from portbench import harness, spec
cell = spec.load_cell({name!r}, pathlib.Path({str(cell.bench_dir)!r}), overrides={SMALL[name]!r})
r = harness.run(cell, {SEED}, 0.3, False, time.perf_counter(), device="cpu", card_check=False)
loaded = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"result": r, "forbidden": harness.forbidden_modules(), "port": "tcnn_tpu_torch" in loaded}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    r = got["result"]
    assert got["forbidden"] == [] and got["port"]
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["attempted"] > 0
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in r["metrics"].values())


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints nothing
    on standard output."""
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "hash_image.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tcnn_tpu_torch_fake", object())
    assert "tcnn_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tcnn_tpu.trainer", object())
    assert "tcnn_tpu" in harness.forbidden_modules()


def test_traced_cpu_run_reports_nothing_it_cannot_read(tmp_path):
    """On the CPU the trace holds no kernel: the per-layer metrics from the
    trace are left out, busy and window read 0, the run completes."""
    cell = load_small("hash_image.train", tmp_path)
    r = harness.run(cell, SEED, 0.2, True, time.perf_counter(), device="cpu", card_check=False)
    assert set(r["metrics"]) == {"entry.host_ms.train"}
    assert r["device"]["busy_s"] == 0.0 and "breakdown" not in r


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_reduction_attributes_kernels_to_their_spans():
    """Two steps, each launching a model kernel and an optimizer kernel;
    a kernel launched outside any step is not counted, the window runs
    from the first owned kernel to the last, gaps are named by the
    innermost open span."""
    ev = [
        _x("pb.step", "user_annotation", 0, 100), _x("pb.optimizer", "user_annotation", 60, 30),
        _x("pb.step", "user_annotation", 200, 100), _x("pb.optimizer", "user_annotation", 260, 30),
        _x("cudaLaunchKernel", "cuda_runtime", 10, 2, 1), _x("cudaLaunchKernel", "cuda_runtime", 70, 2, 2),
        _x("cudaLaunchKernel", "cuda_runtime", 210, 2, 3), _x("cudaLaunchKernel", "cuda_runtime", 270, 2, 4),
        _x("cudaLaunchKernel", "cuda_runtime", 150, 2, 5),
        _x("model", "kernel", 20, 40, 1), _x("adam", "kernel", 80, 10, 2),
        _x("model", "kernel", 220, 40, 3), _x("adam", "kernel", 280, 10, 4),
        _x("stray", "kernel", 150, 10, 5),
    ]
    s = trace.summarize(ev)
    assert s.n_units == 2 and s.covered == 2
    assert s.per_unit("kernels") == 2
    assert s.per_unit("kernel_s") == pytest.approx(50e-6)
    assert s.per_unit("optimizer_kernel_s") == pytest.approx(10e-6)
    assert s.window_s == pytest.approx(270e-6)
    assert s.busy_s == pytest.approx(110e-6)
    assert s.device_ops[0] == ["model", pytest.approx(80e-6)]
    names = dict(s.idle_gaps)
    # 60-80 and 260-280 while the optimizer's span was open; 90-150 and
    # 160-220 between the steps
    assert names["pb.optimizer"] == pytest.approx(40e-6)
    assert names["(host outside the benchmark's spans)"] == pytest.approx(120e-6)
    assert sum(names.values()) == pytest.approx(270e-6 - 110e-6)
