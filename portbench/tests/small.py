"""Tiny sizes of each cell for CPU tests: the widths stay, the batch, the
ring, the image and the frames shrink. The cells PERF.md keeps for later
(`later_cells.json`: their BENCHMARK.json entries) are tested in a copy of
the benchmark with those entries added, as a later PR would add them."""

import json
import pathlib
import shutil
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH.parent))

from portbench import spec  # noqa: E402

SEED = 2**31 + 123

SMALL = {
    "hash_image.train": {"batch": 1024, "ring": 4, "image_size": 64, "warmup": 1,
                         "trace_wait": 1, "trace_units": 2, "probe_units": 2},
    "sdf_grid.eikonal": {"batch": 2048, "ring": 4, "warmup": 1,
                         "trace_wait": 1, "trace_units": 2, "probe_units": 1},
    "hash_image.infer": {"views": 3, "height": 36, "width": 64, "chunk": 1000, "warmup": 1,
                         "trace_wait": 1, "trace_units": 2, "probe_units": 2},
    "hash_image.modules": {"batch": 1024, "ring": 4, "image_size": 64, "warmup": 1,
                           "trace_wait": 1, "trace_units": 2, "probe_units": 2},
    "ngp_image.train": {"batch": 1024, "ring": 4, "image_size": 64, "warmup": 1,
                        "trace_wait": 1, "trace_units": 2, "probe_units": 2},
    "oneblob_image.train": {"batch": 1024, "ring": 4, "image_size": 64, "warmup": 1,
                            "trace_wait": 1, "trace_units": 2, "probe_units": 2},
}


def bench_dir_with_later_cells(tmp: pathlib.Path) -> pathlib.Path:
    """A copy of the benchmark under `tmp` whose BENCHMARK.json also holds
    the cells kept for later, with the training metrics reported there."""
    bench_dir = tmp / "portbench"
    if not bench_dir.exists():
        shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
        bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
        later = json.loads((BENCH / "tests" / "later_cells.json").read_text())
        bench["configs"] += later["configs"]
        bench["workloads"] += later["workloads"]
        names = [w["name"] for w in later["workloads"]]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "hash_image.train" in m.get("workloads", []) and not m["name"].startswith("optimizer."):
                m["workloads"] += names
            elif m["name"].startswith("optimizer."):
                m["workloads"].append("sdf_grid.eikonal")
        (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_dir


def load_small(name: str, tmp: pathlib.Path):
    """The cell `name` at its tiny size, from the benchmark or, for a cell
    kept for later, from a copy under `tmp` that holds it."""
    cells = {w["name"] for w in json.loads((BENCH.parent / "BENCHMARK.json").read_text())["workloads"]}
    bench_dir = BENCH if name in cells else bench_dir_with_later_cells(tmp)
    return spec.load_cell(name, bench_dir, overrides=SMALL[name])


def driver_of(name: str) -> str:
    """The driver of cell `name`, from its mix, whether the benchmark or
    `later_cells.json` holds the cell."""
    workloads = (json.loads((BENCH.parent / "BENCHMARK.json").read_text())["workloads"]
                 + json.loads((BENCH / "tests" / "later_cells.json").read_text())["workloads"])
    traffic = next(w["traffic"] for w in workloads if w["name"] == name)
    return json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())["driver"]
