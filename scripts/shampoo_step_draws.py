#!/usr/bin/env python3
"""Shampoo's refresh step (step 1: every group's inverse fourth roots) on the
card against the same step on the CPU, over seeded draws on config_hash's
param vector, on one CUDA GPU:

    python3 scripts/shampoo_step_draws.py [DRAWS]

Each draw makes the weights (the network's init, the table from U(-1, 1))
and a gradient (N(0, 1) x 128, 30% exact zeros in the table) as
chip_smoke.py's check_optimizer_steps does, from a generator seeded
3000 + draw, and runs the step on the CPU, on the card, and on the card
with TF32 matmuls (the step without its pinned precision, under
`shampoo.matmul_precision("high")`). Prints one JSON line per draw: each
state matrix's norm-relative error card vs CPU and TF32 vs CPU, and the
2-norm condition number (float64, on the CPU) of each symmetrised Gram
factor whose root is taken. chip_smoke.py's SHAMPOO_STEP_REL bounds the
card's errors. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

DRAWS = int(sys.argv[1]) if len(sys.argv) > 1 else 8


def nre(a, b) -> float:
    import torch

    a, b = a.cpu().double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("shampoo_step_draws: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.optimizers import shampoo

    dev = torch.device("cuda", 0)
    cfg = tt.load_config(str(ROOT / "data" / "config_hash.json"))
    net = tt.create_network_with_input_encoding(2, 3, cfg["encoding"], cfg["network"])
    n, sizes, n_net = net.n_params, net.layer_sizes(), net.network.n_params
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "n_params": n,
                      "limit": cs.SHAMPOO_STEP_REL}), flush=True)
    for draw in range(DRAWS):
        gen = torch.Generator().manual_seed(3000 + draw)
        w0 = torch.cat([net.network.init_params(gen),
                        torch.rand(n - n_net, generator=gen) * 2 - 1])
        g = torch.randn(n, generator=gen) * 128.0
        g[n_net:][torch.rand(n - n_net, generator=gen) < 0.3] = 0.0
        runs = {}
        for run in ("cpu", "card", "tf32"):
            opt = tt.create_optimizer(cs.SHAMPOO_OPTIMIZER)
            opt.allocate(n, sizes)
            d = "cpu" if run == "cpu" else dev
            state, w = opt.init_state(d), w0.to(d, copy=True)
            if run == "tf32":
                with shampoo.matmul_precision("high"):
                    opt._step(state, 128.0, w, g.to(d), 1.0)
            else:
                opt.step(state, 128.0, w, g.to(d))
            torch.cuda.synchronize()
            runs[run] = (opt, state, w)
        ref_opt, ref, ref_w = runs["cpu"]
        line = {"draw": draw, "card": {"weights": nre(runs["card"][2], ref_w)},
                "tf32": {"weights": nre(runs["tf32"][2], ref_w)}, "cond": {}}
        for key, want in ref.items():
            if want.dim() == 3:  # the Gram factors and their roots
                for run in ("card", "tf32"):
                    line[run][key] = nre(runs[run][1][key], want)
                if "root" not in key:
                    sym = ref_opt._symmetrize(want).double()
                    line["cond"][key] = float(torch.linalg.cond(sym).max())
        line["card_max"] = max(line["card"].values())
        line["tf32_min_root"] = min(v for k, v in line["tf32"].items() if "root" in k)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
