"""Adding a cell is adding data: a configuration file, a cell file and
entries in BENCHMARK.json, into a copy of the benchmark, and the harness
finds, validates and runs the new cell with no file of it edited. The
cell is the first one PERF.md keeps for later: tiny-cuda-nn's README
default, config_hash at T=2^19 and per-level scale 2.0, on the mix of
hash_image.train."""

import json
import shutil
import time

import torch

from small import SEED, SMALL
from portbench import harness, spec

SOURCE = spec.HERE


def test_a_cell_added_as_data_is_found_validated_and_run(tmp_path):
    bench_dir = tmp_path / "portbench"
    shutil.copytree(SOURCE, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((SOURCE.parent / "BENCHMARK.json").read_text())
    before = {p.relative_to(bench_dir): p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}

    cfg = json.loads((bench_dir / "configs" / "hash_image.json").read_text())
    cfg["name"] = "ngp_image"
    cfg["source"] = "https://github.com/NVlabs/tiny-cuda-nn/blob/master/README.md"
    cfg["encoding"].update(log2_hashmap_size=19, per_level_scale=2.0)
    (bench_dir / "configs" / "ngp_image.json").write_text(json.dumps(cfg))
    (bench_dir / "workloads" / "ngp_image.train.json").write_text(
        (bench_dir / "workloads" / "hash_image.train.json").read_text())
    bench["configs"].append({"name": "ngp_image", "source": cfg["source"],
                             "file": "portbench/configs/ngp_image.json", "reduced": [],
                             "why": "the README's default grid, T=2^19 and scale 2.0"})
    bench["workloads"].append({"name": "ngp_image.train", "config": "ngp_image",
                               "traffic": "image_fit_b2e18", "chips": 1,
                               "why": "Trainer.training_step at B=2^18 with a table near the L2's size"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "hash_image.train" in m.get("workloads", []):
            m["workloads"].append("ngp_image.train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    assert spec.validate(bench_dir) == []
    for path, data in before.items():
        assert (bench_dir / path).read_bytes() == data, f"{path} was edited"

    cell = spec.load_cell("ngp_image.train", bench_dir, overrides=SMALL["hash_image.train"])
    assert cell.config["encoding"]["log2_hashmap_size"] == 19
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
