"""Each cell on the card, a short window, in a process of its own: the
result line, `correct` true. Skips without a card (run on the chip with
python -m pytest portbench/tests -m card)."""

import json
import pathlib
import subprocess
import sys

import pytest

import small  # noqa: F401
from portbench import spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(card, name):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed",
                          str(2**31 + 5), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert set(r["metrics"]) == {m["name"] for m in spec.load_cell(name).end_to_end}
