"""One run of one cell: set-up, the measured window, the traced units, the
check of what the window's path produced against the plain reference, and
the result line.

A driver (`traffic/<driver>.py`) provides
  UNIT                    "step" or "frame"
  SYNC_EACH               whether each unit ends in synchronize() (a frame)
  setup(cell, seed, dev)  the program's state, driven through its first
                          units; `state.samples_per_unit`, `state.work`
                          (counts.Work of a unit) and `state.optimizer_s`
                          (least seconds of its optimizer, or None)
  unit(state, i)          enqueue the window's unit i
  spans(state)            a context that opens the benchmark's spans inside
                          a unit (traced runs only)
  readings(state)         what the window's path produced, for the check
  reference(cell, seed, dev, precision)   the plain reference's readings
  compare(program, reference, cell)       {number: value}
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import sys
import tempfile
import time

import torch

from . import compare, spec, trace

#: top-level modules no run may load: the JAX package and JAX itself, and
#: the repository's JAX-era benchmarks and card harness
FORBIDDEN = ("jax", "jaxlib", "flax", "tcnn_tpu", "chip_smoke", "bench", "benchmarks")


class NoCard(RuntimeError):
    pass


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def check_card(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: this benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, {torch.cuda.device_count()} found")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    def __init__(self):
        self.units = 0
        self.seconds = 0.0
        self.latencies = []   # host seconds of each unit (a frame: to its synchronize)


def _profiler(plan: dict, trace_dir: str):
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)

    def export(prof):
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

    return profile(activities=activities,
                   schedule=schedule(wait=plan["wait"], warmup=plan["warmup"],
                                     active=plan["active"], repeat=1),
                   on_trace_ready=export)


def window(driver, state, seconds: float, device, plan: dict | None, trace_dir: str | None) -> Window:
    """Units back to back for `seconds` on the host clock, then a
    synchronize; every unit enqueued counts. With `plan`, the profiler
    skips `wait` units, warms up over `warmup` and records `active`; the
    device is synchronised before the last recorded unit closes, so that
    its kernels are in the trace, and the window runs on until they are."""
    w = Window()
    sync_each = driver.SYNC_EACH
    span = "pb.frame" if driver.UNIT == "frame" else "pb.step"
    prof = _profiler(plan, trace_dir) if plan else None
    last_traced = plan["wait"] + plan["warmup"] + plan["active"] - 1 if plan else -1
    spans_ctx = driver.spans(state) if plan else None
    if prof is not None:
        prof.start()
        spans_ctx.__enter__()
    try:
        t0 = time.perf_counter()
        i = 0
        while True:
            ts = time.perf_counter()
            if prof is not None and i <= last_traced:
                with torch.profiler.record_function(span):
                    driver.unit(state, i)
                    if sync_each:
                        sync(device)
                if i == last_traced:
                    sync(device)
                prof.step()
            else:
                driver.unit(state, i)
                if sync_each:
                    sync(device)
            te = time.perf_counter()
            w.latencies.append(te - ts)
            i += 1
            if te - t0 >= seconds and i > last_traced:
                break
        sync(device)
        w.seconds = time.perf_counter() - t0
        w.units = i
    finally:
        if prof is not None:
            spans_ctx.__exit__(None, None, None)
            prof.stop()
    return w


def host_probe(driver, state, device, units: int, start: int) -> list:
    """Host seconds to enqueue a unit on an empty queue: each unit's calls
    timed after a synchronize, without the synchronize that ends a frame."""
    out = []
    for k in range(units):
        sync(device)
        ts = time.perf_counter()
        driver.unit(state, start + k)
        out.append(time.perf_counter() - ts)
    sync(device)
    return out


class RunRecord:
    """What the metric readers read."""

    def __init__(self, cell, setup_s, win, state_info, trace_summary, host_s):
        self.cell = cell
        self.setup_s = setup_s
        self.window = win
        self.samples_per_unit = state_info["samples_per_unit"]
        self.work = state_info["work"]
        self.optimizer_s = state_info["optimizer_s"]
        self.trace = trace_summary
        self.host_s = host_s


def run(cell, seed: int, seconds: float, traced: bool, t_start: float, device="cuda",
        card_check=True, log=None) -> dict:
    """One run of `cell`; returns the result (its last key "checks")."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    if card_check:
        check_card(cell.chips)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    driver = spec.load_driver(cell)
    t_driver = time.perf_counter()
    state = driver.setup(cell, seed, device)
    sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"setup: {t_driver - t_start:.3f} s to the driver (imports, the card), "
        f"{setup_s - (t_driver - t_start):.3f} s in it (model, inputs, first units)")
    info = {"samples_per_unit": state.samples_per_unit, "work": state.work,
            "optimizer_s": state.optimizer_s}

    plan = None
    trace_dir = None
    if traced:
        plan = {"wait": int(cell.mix.get("trace_wait", 10)), "warmup": 5,
                "active": int(cell.mix["trace_units"])}
        trace_dir = tempfile.mkdtemp(prefix="portbench_trace_")
    try:
        win = window(driver, state, seconds, device, plan, trace_dir)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        summary, host_s = None, None
        if traced:
            host_s = host_probe(driver, state, device, int(cell.mix.get("probe_units", 30)), win.units)
            path = os.path.join(trace_dir, "trace.json")
            summary = trace.load(path) if os.path.exists(path) else None
    finally:
        if trace_dir:
            shutil.rmtree(trace_dir, ignore_errors=True)
    lat = sorted(win.latencies)
    half = len(win.latencies) // 2
    log(f"window: {win.units} units in {win.seconds:.3f} s; unit host ms p10 {1e3 * lat[len(lat) // 10]:.4f} "
        f"p50 {1e3 * lat[len(lat) // 2]:.4f} p90 {1e3 * lat[9 * len(lat) // 10]:.4f}; "
        f"halves {1e3 * sum(win.latencies[:half]) / max(half, 1):.4f} / "
        f"{1e3 * sum(win.latencies[half:]) / max(len(lat) - half, 1):.4f} ms a unit")
    if summary is not None:
        log(f"trace: {summary.covered} of {summary.n_units} traced units hold kernels; "
            f"window {summary.window_s:.6f} s, busy {summary.busy_s:.6f} s")

    program = driver.readings(state)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = driver.reference(cell, seed, device, "f32")
    numbers = driver.compare(program, ref, cell)
    del program, ref
    checks, failed = compare.judge(numbers, cell.limits)

    record = RunRecord(cell, setup_s, win, info, summary, host_s)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.load_reader(m["name"], cell.bench_dir).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if traced:
        dev["busy_s"] = summary.busy_s if summary else 0.0
        dev["window_s"] = summary.window_s if summary else 0.0
    result = {"correct": bool(checks) and not failed, "attempted": win.units,
              "failed": len(failed), "metrics": metrics, "device": dev}
    if traced and summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    if "_leaves" in numbers:
        log(f"worst leaves: {json.dumps(numbers['_leaves'])}")
    result["checks"] = checks
    return result


def check_lines(checks: dict) -> list:
    return [f"check {name}: {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]
