"""The check fails what it must: each fault a cell can have, planted in
the program under a run on the CPU at a tiny size, and the float8 control
put in the program's place, both read as not correct against the limits
of the cell's own file."""

import time

import pytest
import torch

from small import SEED, SMALL, driver_of, load_small
from portbench import compare, faults, harness, spec

CASES = [(name, kind) for name in sorted(SMALL) for kind in faults.KINDS[driver_of(name)]]


@pytest.mark.parametrize("name,kind", CASES)
def test_a_planted_fault_is_not_correct(name, kind, tmp_path):
    torch.set_num_threads(2)
    cell = load_small(name, tmp_path)
    assert cell.limits, "the cell's file holds its limits"
    with faults.plant(cell.driver, kind):
        r = harness.run(cell, SEED, 0.2, False, time.perf_counter(), device="cpu", card_check=False)
    assert r["correct"] is False
    assert r["failed"] > 0


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_float8_control_is_not_correct(name, tmp_path):
    torch.set_num_threads(2)
    cell = load_small(name, tmp_path)
    driver = spec.load_driver(cell)
    cpu = torch.device("cpu")
    numbers = driver.compare(driver.reference(cell, SEED, cpu, "fp8"),
                             driver.reference(cell, SEED, cpu, "f32"), cell)
    checks, failed = compare.judge(numbers, cell.limits)
    assert failed, checks
