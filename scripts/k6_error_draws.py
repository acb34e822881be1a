#!/usr/bin/env python3
"""K6's error against its plain twin over seeded draws at config_hash with
8 features per level (chip_smoke.py phase 3c's model) and at config_hash
itself, on one CUDA GPU, with the package and chip_smoke.py helpers of the
checkout given:

    python3 scripts/k6_error_draws.py [CHECKOUT]

CHECKOUT (default: the checkout holding this script) is built and run as
it is, so two checkouts (for example a parent unpacked with `git archive`)
read the same draws: for each draw, the model of `reference_model(cfg,
seed, ...)` (table redrawn from U(-1, 1)) and x, targets at B = 2^18 from
a generator seeded 2000 + draw. Prints one JSON line per draw: the weights'
and the table's norm-relative error of K6's gradient (chip_smoke.py's
K6_REL bounds them by 2e-5 and 2e-4). Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else __file__).resolve()
if ROOT.is_file():
    ROOT = ROOT.parents[1]
sys.path.insert(0, str(ROOT))

DRAWS = 8
B = 1 << 18


def nre(a, b) -> float:
    import torch

    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k6_error_draws: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.ops.cuda import train_kernel

    dev = torch.device("cuda", 0)
    cfg = tt.load_config(str(ROOT / "data" / "config_hash.json"))
    for label, enc in (("F=8", {"n_features_per_level": 8}), ("config_hash", {})):
        for draw in range(DRAWS):
            gen = torch.Generator().manual_seed(2000 + draw)
            m = cs.reference_model(cfg, cs.SEED + 40, dev, gen, **enc)
            net, tr = m.network, m.trainer
            x = torch.rand(B, 2, generator=gen).to(dev)
            t = torch.rand(B, 3, generator=gen).to(dev)
            prep = train_kernel.prepare_forward(net, tr.params)
            _, kg = train_kernel.fused_train_grads(net, tr.loss_fn, tr.params, x, t,
                                                   tr.loss_scale)
            _, pg = train_kernel._fused_train_grads_plain(
                prep.plan, prep.dims, net.encoding.active_levels(), prep.table, prep.weights,
                tr.loss_fn, x, t, tr.loss_scale, None, None, False)
            n = prep.dims.n_weights
            print(json.dumps({"checkout": str(ROOT), "config": label, "draw": draw,
                              "weights": nre(kg[:n], pg[:n]), "table": nre(kg[n:], pg[n:])}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
