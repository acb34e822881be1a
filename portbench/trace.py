"""Reduction of a torch.profiler chrome trace to what the per-layer
metrics read.

The benchmark opens spans (`record_function`, names starting "pb.") around
each unit of work (a step or a frame) and around the optimizer. A kernel
belongs to the unit during whose span the host launched it: the kernel's
correlation id leads to its launch on the host, whose time falls inside
one unit span. The traced window runs from the first kernel of the first
traced unit to the end of the last kernel of the last one; device
operations (kernels, copies, fills) inside it make the busy time, and the
gaps between them are named by the innermost benchmark span open on the
host at the gap's middle.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "pb."
UNIT_SPANS = ("pb.step", "pb.frame")
OPTIMIZER_SPAN = "pb.optimizer"


@dataclasses.dataclass
class Unit:
    kernels: int = 0
    kernel_s: float = 0.0
    optimizer_kernel_s: float = 0.0
    optimizer_kernels: int = 0


@dataclasses.dataclass
class TraceSummary:
    units: list
    window_s: float
    busy_s: float
    device_ops: list   # [[name, seconds]], longest first
    idle_gaps: list    # [[host span, seconds]], longest first

    @property
    def n_units(self) -> int:
        return len(self.units)

    @property
    def covered(self) -> int:
        """Traced units in which a kernel was recorded."""
        return sum(1 for u in self.units if u.kernels)

    def per_unit(self, field: str) -> float:
        return sum(getattr(u, field) for u in self.units) / len(self.units)


class _Spans:
    """Non-overlapping host spans of one name, sorted, for lookups."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.events]

    def find(self, ts: float):
        i = bisect.bisect_right(self.starts, ts) - 1
        if i >= 0 and ts <= self.events[i]["ts"] + self.events[i]["dur"]:
            return i
        return None


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def summarize(events: list, top: int = 10) -> TraceSummary | None:
    """The summary of a chrome trace's events, or None when no traced unit
    launched a kernel."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    spans = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX)]
    units = _Spans([e for e in spans if e["name"] in UNIT_SPANS])
    opt = _Spans([e for e in spans if e["name"] == OPTIMIZER_SPAN])
    launch_ts = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    per_unit = [Unit() for _ in units.events]
    owned = []
    for e in dev:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        i = None if ts is None else units.find(ts)
        if i is None:
            continue
        owned.append(e)
        if e.get("cat") != "kernel":
            continue
        u = per_unit[i]
        u.kernels += 1
        u.kernel_s += e["dur"] * 1e-6
        if opt.find(ts) is not None:
            u.optimizer_kernels += 1
            u.optimizer_kernel_s += e["dur"] * 1e-6
    if not any(u.kernels for u in per_unit):
        return None
    start = min(e["ts"] for e in owned)
    end = max(e["ts"] + e["dur"] for e in owned)
    inside = [(max(e["ts"], start), min(e["ts"] + e["dur"], end)) for e in dev
              if e["ts"] < end and e["ts"] + e["dur"] > start]
    busy = _union(inside)
    by_name = collections.Counter()
    for e in dev:
        if e["ts"] < end and e["ts"] + e["dur"] > start:
            by_name[_short(e.get("name", "?"))] += (min(e["ts"] + e["dur"], end) - max(e["ts"], start)) * 1e-6
    # gaps, each named by the innermost benchmark span open at its middle
    nested = sorted(spans, key=lambda e: e["dur"])
    gaps = collections.Counter()
    for (a0, a1), (b0, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a1 + b0)
        name = next((s["name"] for s in nested if s["ts"] <= mid <= s["ts"] + s["dur"]),
                    "(host outside the benchmark's spans)")
        gaps[name] += (b0 - a1) * 1e-6
    return TraceSummary(
        units=per_unit,
        window_s=(end - start) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        device_ops=[[n, s] for n, s in by_name.most_common(top)],
        idle_gaps=[[n, s] for n, s in gaps.most_common(top)],
    )


def load(path: str) -> TraceSummary | None:
    with open(path) as f:
        return summarize(json.load(f).get("traceEvents", []))
