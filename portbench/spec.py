"""The benchmark's definition, found by name.

`BENCHMARK.json` at the checkout's root lists the configurations, the cells
and the metrics. Each of them has its own files under `portbench/`:

  configs/<config>.json      the configuration as it is run (the entry's `file`)
  traffic/<traffic>.json     a traffic mix: its driver and its parameters
  traffic/<driver>.py        the driver, the loop a user of that path runs
  workloads/<cell>.json      the cell's limits for `correct`, with the readings
  metrics/<metric>.py        a metric's reader: `read(run)` -> value or None

so a cell, a configuration, a mix or a metric is added by adding files and
entries, and nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def checkout_root(bench_dir: pathlib.Path = HERE) -> pathlib.Path:
    return bench_dir.parent


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    limits: dict
    end_to_end: list   # the BENCHMARK.json entries this cell reports
    per_layer: list
    bench_dir: pathlib.Path

    @property
    def driver(self) -> str:
        return self.mix["driver"]


def _applies(metric: dict, cell: str, reported=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(name: str, bench_dir: pathlib.Path = HERE, overrides: dict | None = None) -> Cell:
    """The cell `name` of `<checkout>/BENCHMARK.json`, with its files read;
    `overrides` replaces mix parameters (tests run a cell at a tiny size)."""
    bench = _json(checkout_root(bench_dir) / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    root = checkout_root(bench_dir)
    mix = dict(_json(bench_dir / "traffic" / f"{w['traffic']}.json"))
    mix.update(overrides or {})
    cell_file = _json(bench_dir / "workloads" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, _json(root / cfg_entry["file"]), mix,
                int(w["chips"]), dict(cell_file.get("limits", {})), e2e, per_layer, bench_dir)


def _load_module(path: pathlib.Path, tag: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench_{tag}_{re.sub(r'[^A-Za-z0-9_]', '_', path.stem)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(cell: Cell):
    return _load_module(cell.bench_dir / "traffic" / f"{cell.driver}.py", "driver")


def load_reader(metric: str, bench_dir: pathlib.Path = HERE):
    return _load_module(bench_dir / "metrics" / f"{metric}.py", "metric")


def validate(bench_dir: pathlib.Path = HERE) -> list:
    """Problems with the benchmark's files as BENCHMARK.json names them
    (empty when every cell, configuration, mix, driver and reader is found
    and well formed)."""
    problems = []
    root = checkout_root(bench_dir)
    bench = _json(root / "BENCHMARK.json")
    metrics = bench["end_to_end"] + bench["per_layer"]
    for entry in bench["configs"] + bench["workloads"] + metrics:
        if not NAME.match(entry["name"]):
            problems.append(f"bad name {entry['name']!r}")
    configs = {c["name"]: c for c in bench["configs"]}
    used = set()
    for c in bench["configs"]:
        path = root / c["file"]
        if not path.is_file():
            problems.append(f"config {c['name']}: no file {c['file']}")
            continue
        cfg = _json(path)
        for key in ("n_input_dims", "n_output_dims", "encoding", "network", "compute_dtype"):
            if key not in cfg:
                problems.append(f"config {c['name']}: no key {key}")
    names = {m["name"] for m in metrics}
    for w in bench["workloads"]:
        used.add(w["config"])
        if w["config"] not in configs:
            problems.append(f"cell {w['name']}: unknown config {w['config']}")
        mix_path = bench_dir / "traffic" / f"{w['traffic']}.json"
        if not mix_path.is_file():
            problems.append(f"cell {w['name']}: no traffic file {mix_path.name}")
        else:
            driver = _json(mix_path).get("driver")
            if not driver or not (bench_dir / "traffic" / f"{driver}.py").is_file():
                problems.append(f"cell {w['name']}: no driver {driver!r}")
        if not (bench_dir / "workloads" / f"{w['name']}.json").is_file():
            problems.append(f"cell {w['name']}: no workloads/{w['name']}.json")
        if w.get("chips") not in (1, 4):
            problems.append(f"cell {w['name']}: chips must be 1 or 4")
    for c in configs:
        if c not in used:
            problems.append(f"config {c} is used by no cell")
    for m in metrics:
        if not (bench_dir / "metrics" / f"{m['name']}.py").is_file():
            problems.append(f"metric {m['name']}: no reader metrics/{m['name']}.py")
        if "moves" in m and m["moves"] not in names:
            problems.append(f"metric {m['name']}: moves unknown {m['moves']}")
        for cell in m.get("workloads", []):
            if cell not in {w["name"] for w in bench["workloads"]}:
                problems.append(f"metric {m['name']}: unknown cell {cell}")
    return problems
