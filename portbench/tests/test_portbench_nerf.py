"""The NeRF cell `ngp_nerf.train` on the CPU at a tiny size: the benchmark
finds its files by name and validates; a run is correct; each fault of its
driver's FAULTS, and the float8 control, read as not correct against the
limits of the cell's own file. Its counts match the configuration."""

import time

import pytest
import torch

from small import SEED  # noqa: F401  (the checkout's root on sys.path)
from portbench import compare, harness, spec
from portbench.counts import nerf as counts
from portbench.reference import nerf as ref

CELL = "ngp_nerf.train"
#: 4,096 samples of rays of mean 16 in a ring of 3; widths as published
TINY = {"batch": 4096, "ring": 3, "mean_samples": 16, "steps": 64, "warmup": 1,
        "trace_wait": 1, "trace_units": 2, "probe_units": 1}
NUMBERS = {"loss_gap", "grad_gap", "grad_mid_gap", "change_gap", "ema_gap"}


@pytest.fixture(scope="module")
def cell():
    torch.set_num_threads(2)
    return spec.load_cell(CELL, overrides=TINY)


def test_the_cell_is_found_by_name_and_validates(cell):
    assert spec.validate() == []
    assert cell.driver == "nerf_step" and cell.config["name"] == "ngp_nerf"
    assert set(cell.limits) == NUMBERS
    assert spec.load_driver(cell).UNIT == "step"
    per_layer = {m["name"] for m in cell.per_layer}
    assert {"nerf.fields_host_ms.train", "nerf.composite_host_ms.train",
            "nerf.backward_host_ms.train"} <= per_layer
    # K6's spans: the composed route opens none
    assert not {"kernels.prepare_host_ms.train", "kernels.launch_host_ms.train"} & per_layer
    assert {m["name"] for m in cell.end_to_end} == {"train_samples_per_s", "setup_s"}


def test_a_cpu_run_is_correct(cell):
    r = harness.run(cell, SEED, 0.2, False, time.perf_counter(), device="cpu", card_check=False)
    assert r["correct"] is True, r["checks"]
    assert set(r["checks"]) == NUMBERS
    assert r["attempted"] > 0 and r["metrics"]["train_samples_per_s"]["value"] > 0


@pytest.mark.parametrize("kind", ["unchanged", "half", "opaque", "no_ema"])
def test_each_fault_is_not_correct(cell, kind):
    driver = spec.load_driver(cell)
    with driver.FAULTS[kind]():
        r = harness.run(cell, SEED, 0.2, False, time.perf_counter(), device="cpu", card_check=False)
    assert r["correct"] is False and r["failed"] > 0


def test_the_float8_control_is_not_correct(cell):
    driver = spec.load_driver(cell)
    cpu = torch.device("cpu")
    numbers = driver.compare(driver.reference(cell, SEED, cpu, "fp8"),
                             driver.reference(cell, SEED, cpu, "f32"), cell)
    checks, failed = compare.judge(numbers, cell.limits)
    # the median leaf moves in most leaves where the worst leaf swings
    assert "grad_mid_gap" in failed, checks


def test_the_median_leaf_gap_by_hand(cell):
    """Leaves of reference norms 3, 4 and 5 (median 4) read 3.3, 4.2 and
    5: gaps 0.3 / 4, 0.2 / 4 and 0, of which the median is 0.05."""
    driver = spec.load_driver(cell)
    leaves = [("a", 0, 1), ("b", 1, 2), ("c", 2, 3)]
    gap = driver.median_leaf_gap(torch.tensor([3.3, 4.2, 5.0]), torch.tensor([3.0, 4.0, 5.0]), leaves)
    assert gap == pytest.approx(0.05, rel=1e-6)


def test_counts_follow_the_configuration(cell):
    """12,206,480 parameters, as the reference lays them out; the least
    time of a step at 2^20 samples is its operations' (the MLPs' 3 x 2 x
    9,408 FLOPs a sample at their own widths, the grid's 12 ops a corner)."""
    cfg = cell.config
    assert counts.n_params(cfg) == ref.Nerf(cfg).n_params == 12_206_480
    leaves = ref.Nerf(cfg).leaves()
    assert leaves[0][1] == 0 and leaves[-1][2] == 12_206_480
    assert all(a[2] == b[1] for a, b in zip(leaves, leaves[1:]))
    w = counts.train_step(cfg, 1 << 20, 8192)
    assert w.mlp_flops == 6 * (3072 + 6336) * (1 << 20)
    assert w.grid_ops > 16 * 8 * 12 * (1 << 20)
    assert w.least_seconds() == pytest.approx(w.mlp_flops / 989e12 + w.grid_ops / 67e12)
