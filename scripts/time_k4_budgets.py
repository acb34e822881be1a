#!/usr/bin/env python3
"""K4's time at each shared-memory budget for its private levels, on one
CUDA GPU:

    python3 scripts/time_k4_budgets.py

K4 (``csrc/grid_bwd.cu``) sums the leading dense levels of the table
gradient in a block's shared memory; `grid_kernel.private_levels` picks
them to fit `grid_kernel.K4_PRIVATE_BYTES`. This script sets that constant
to each budget in turn: 0 (no private level: every level by vector
atomics), 115,712 bytes (two 512-thread blocks an SM) and 232,448 bytes
(one block an SM), and for each holds K4 against its plain twin
(norm-relative error) and times it with CUDA events (50 launches, best of
two turns, budgets in turns) at B = 2^18 on data/config_hash.json and at
the reference's default hash grid (log2_hashmap_size 19, per_level_scale
2.0), plain and stochastic, on random bf16 cotangents. Prints one JSON
line per configuration with the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

B = 1 << 18
ITERS = 50
BUDGETS = (0, 115_712, 232_448)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_k4_budgets: no CUDA device available", file=sys.stderr)
        return 1
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.ops.cuda import grid_kernel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = tt.load_config(str(ROOT / "data" / "config_hash.json"))
    gen = torch.Generator().manual_seed(1234)
    reference = {"log2_hashmap_size": 19, "per_level_scale": 2.0}
    for label, enc in (("config_hash", {}), ("config_hash stochastic", {"stochastic_interpolation": True}),
                       ("reference T=2^19", reference),
                       ("reference T=2^19 stochastic", {**reference, "stochastic_interpolation": True})):
        c = json.loads(json.dumps(cfg))
        c["encoding"].update(enc)
        m = tt.create_from_config(2, 3, c, seed=1234, device="cuda")
        plan, L = m.network.encoding.plan, m.network.encoding.plan.n_levels
        x = torch.rand(B, 2, generator=gen).cuda()
        gy = torch.randn(B, m.network.encoding.padded_output_width,
                         generator=gen).to(torch.bfloat16).cuda()
        want = grid_kernel._grid_backward_plain(plan, x, gy, L).double()
        ms, err, private = {b: [] for b in BUDGETS}, {}, {}
        for _ in range(2):
            for budget in BUDGETS:
                grid_kernel.K4_PRIVATE_BYTES = budget
                private[budget] = grid_kernel.private_levels(plan, L, budget)[0]
                got = grid_kernel.grid_backward(plan, x, gy, L).double()
                err[budget] = float(torch.linalg.vector_norm(got - want)
                                    / torch.linalg.vector_norm(want))
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(ITERS):
                    grid_kernel.grid_backward(plan, x, gy, L)
                end.record()
                torch.cuda.synchronize()
                ms[budget].append(start.elapsed_time(end) / ITERS)
        print(json.dumps({"config": label, "B": B, "card": smi,
                          "k4_ms": {str(b): min(v) for b, v in ms.items()}, "turns_ms": ms,
                          "private_levels": private, "norm_rel_err": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
