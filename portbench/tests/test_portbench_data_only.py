"""Adding a cell is adding data: a configuration file, a cell file and
entries in BENCHMARK.json, into a copy of the benchmark, and the harness
finds, validates and runs the new cell with no file of it edited. The
cell is one the benchmark does not hold: config_hash with a table of
2^17 rows a level, on the mix of hash_image.train."""

import json
import shutil
import time

import torch

from small import SEED, SMALL
from portbench import harness, spec

SOURCE = spec.HERE
CELL = "hash_t17.train"


def test_a_cell_added_as_data_is_found_validated_and_run(tmp_path):
    bench_dir = tmp_path / "portbench"
    shutil.copytree(SOURCE, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((SOURCE.parent / "BENCHMARK.json").read_text())
    assert CELL not in {w["name"] for w in bench["workloads"]}, "the example must be a cell to add"
    before = {p.relative_to(bench_dir): p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}

    cfg = json.loads((bench_dir / "configs" / "hash_image.json").read_text())
    cfg["name"] = "hash_t17"
    cfg["encoding"].update(log2_hashmap_size=17)
    (bench_dir / "configs" / "hash_t17.json").write_text(json.dumps(cfg))
    (bench_dir / "workloads" / f"{CELL}.json").write_text(
        (bench_dir / "workloads" / "hash_image.train.json").read_text())
    bench["configs"].append({"name": "hash_t17", "source": cfg["source"],
                             "file": "portbench/configs/hash_t17.json", "reduced": ["encoding"],
                             "why": "config_hash with T=2^17"})
    bench["workloads"].append({"name": CELL, "config": "hash_t17",
                               "traffic": "image_fit_b2e18", "chips": 1,
                               "why": "Trainer.training_step at B=2^18 with a 5.5 MB table"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "hash_image.train" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    assert spec.validate(bench_dir) == []
    for path, data in before.items():
        assert (bench_dir / path).read_bytes() == data, f"{path} was edited"

    cell = spec.load_cell(CELL, bench_dir, overrides=SMALL["hash_image.train"])
    assert cell.config["encoding"]["log2_hashmap_size"] == 17
    assert {m["name"] for m in cell.end_to_end} == {"train_samples_per_s", "setup_s"}
    torch.set_num_threads(2)
    r = harness.run(cell, SEED, 0.2, False, time.perf_counter(), device="cpu", card_check=False)
    assert r["attempted"] > 0 and r["metrics"]["train_samples_per_s"]["value"] > 0
    assert set(r["checks"]) == {"loss_gap", "grad_gap", "change_gap"}


def test_validate_names_what_is_missing(tmp_path):
    bench_dir = tmp_path / "portbench"
    shutil.copytree(SOURCE, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((SOURCE.parent / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "hash_image.nowhere", "config": "hash_image",
                               "traffic": "no_such_mix", "chips": 2, "why": "broken on purpose"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    problems = "\n".join(spec.validate(bench_dir))
    assert "no traffic file no_such_mix.json" in problems
    assert "no workloads/hash_image.nowhere.json" in problems
    assert "chips must be 1 or 4" in problems
