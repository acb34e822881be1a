#!/usr/bin/env python3
"""CPU rehearsal of chip_smoke.py's phase 18 on the plain twins: its control
flow at a small size, or the draws that set its data-parallel bound and
the native pipeline's loss-fall limit.

    python scripts/rehearse_parallel_slice.py flow [LOG2_B]
    python scripts/rehearse_parallel_slice.py limits [DRAWS] [WHICH ...]

flow: `parallel_native_slice` end to end on the CPU at B = 2^LOG2_B
(default 12) with a few steps a path: the two ranks spawned with gloo on the
CPU, the "NCCL" group on gloo, `dryrun_multichip` on the CPU; the card's
`torch.cuda` calls stubbed and its times 0. Every check runs; those that
only a card can pass (a kernel's launch count, the trace naming K6's
kernel, the loss fall of a few steps) print "CHECK FAILED" and the run
goes on.

limits: "dp": DRAWS (default 4) seeded draws of phase 18 (a)'s run at the
card's B_MAIN and N_DP_STEPS: two ranks (gloo, CPU) against one process,
the first step's reduced gradient and each stage's params norm-relative
per part, the losses' largest relative difference (the card adds K6's
atomics to the summation order these read), and the same for the control
(the first rank's rows alone, no all-reduce); "native": the native pipeline's N_NATIVE_STEPS steps at
B_MAIN and its loss fall (WHICH: dp, native; default both).
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import tcnn_tpu_torch as tt  # noqa: E402


class _Event:
    """torch.cuda.Event on the host clock."""

    def __init__(self, **kwargs):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def stub_card():
    """The card's calls as no-ops, times 0, failed checks printed."""
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.Event = _Event
    cs.cuda_ms = lambda fn, iters: (fn(), 0.0)[1]

    def check(cond, what):
        if not cond:
            print(f"CHECK FAILED: {what}", flush=True)

    cs.check = check


def flow(log2_b: int) -> None:
    stub_card()
    cs.B_MAIN = 1 << log2_b
    cs.N_DP_STEPS = cs.N_NCCL_STEPS = 2
    cs.N_NATIVE_STEPS = cs.N_PIPELINE_STEPS = cs.N_TIMER_STEPS = 4
    cs.N_TRACE_STEPS = 2
    cs.NCCL_BACKEND = "gloo"
    cfg = tt.load_config(str(ROOT / "data" / "config_hash.json"))
    t0 = time.perf_counter()
    launches = cs.parallel_native_slice(cfg, torch.device("cpu"), "cpu (rehearsal)")
    print(json.dumps({"rehearsal": "flow", "launches": launches,
                      "seconds": time.perf_counter() - t0}))


def dp_limits(draws: int) -> None:
    import numpy as np
    from tcnn_tpu_torch.parallel.data_parallel import spawn_ranks

    torch.cuda.synchronize = lambda *a, **k: None  # norm_errors synchronises
    cfg = tt.load_config(str(ROOT / "data" / "config_hash.json"))
    n_net = tt.create_network_with_input_encoding(2, 3, cfg["encoding"], cfg["network"]) \
        .network.n_params
    for d in range(draws):
        seed = cs.SEED + 80 + 100 * d
        t0 = time.perf_counter()
        ranks = spawn_ranks(cs.dp_rank, cs.N_DP_RANKS,
                            (cfg, "cpu", cs.B_MAIN, cs.N_DP_STEPS, seed), timeout=3600)
        single, first = (cs.dp_run(cfg, torch.device("cpu"), dp_of, steps=cs.N_DP_STEPS,
                                   batch=cs.B_MAIN, seed=seed)
                         for dp_of in (None, cs.FirstShardOnly))

        def rel(run, key):
            return cs.norm_errors(torch.from_numpy(run[key]), torch.from_numpy(single[key]),
                                  {"weights": None, "table": None}, n_net)[0]

        keys = ("grad", "fused params", "external params", "composed params")
        control = {k: rel(first, k) for k in keys}
        rel = {k: rel(ranks[0], k) for k in keys}
        bit_equal = all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ranks[0]
                        if k.endswith("params"))
        loss_rel = float(np.abs(ranks[0]["fused losses"] / single["fused losses"] - 1).max())
        print(json.dumps({"rehearsal": "dp", "draw": d, "seed": seed, "B": cs.B_MAIN,
                          "steps": cs.N_DP_STEPS, "norm_rel": rel, "loss_max_rel": loss_rel,
                          "control_first_rank_rows_alone": control,
                          "ranks_bit_equal": bit_equal,
                          "seconds": time.perf_counter() - t0}), flush=True)


def native_limits() -> None:
    from tcnn_tpu_torch.samples import mlp_learning_an_image as sample
    from tcnn_tpu_torch.utils.image import synthetic_image

    cfg = tt.load_config(str(ROOT / "data" / "config_hash.json"))
    t0 = time.perf_counter()
    _, losses = sample.train(cfg, synthetic_image(1024, 1024, device="cpu"), cs.N_NATIVE_STEPS,
                             device="cpu", log=None, pipeline=sample.native_batches)
    print(json.dumps({"rehearsal": "native", "steps": cs.N_NATIVE_STEPS, "B": cs.B_MAIN,
                      "loss_first": float(losses[0]),
                      "loss_last10_mean": float(losses[-10:].mean()),
                      "loss_fall": float(losses[0] / losses[-10:].mean()),
                      "seconds": time.perf_counter() - t0}), flush=True)


def main() -> None:
    if sys.argv[1] == "flow":
        flow(int(sys.argv[2]) if len(sys.argv) > 2 else 12)
        return
    draws = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    which = sys.argv[3:] or ["dp", "native"]
    if "dp" in which:
        dp_limits(draws)
    if "native" in which:
        native_limits()


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "4")  # each spawned rank's threads
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    main()
