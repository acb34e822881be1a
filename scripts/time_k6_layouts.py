#!/usr/bin/env python3
"""K6's time at each of its layouts, on one CUDA GPU:

    python3 scripts/time_k6_layouts.py

K6 (``csrc/fused_train.cu``) runs blocks of nt rows (nt / 16 warps) and sums
the leading dense levels of the table gradient in each block's spare shared
memory; `train_kernel.train_layout` picks both from
`train_kernel.K6_LAYOUT` = (most rows a tile, blocks an SM). This script
sets that constant to each layout in turn: (128, 1), (64, 2) and (32, 4),
the same warps an SM, with each block's private-level budget SMEM_SM /
blocks less 1 KB. For each it holds K6 against its plain twin (norm-relative
error of the weights' and the table's gradient) and times it with CUDA
events (50 launches, best of two turns, layouts in turns) at B = 2^18 on
data/config_hash.json and at the reference's default hash grid
(log2_hashmap_size 19, per_level_scale 2.0), the table redrawn from
U(-1, 1). Prints one JSON line per configuration with the blocks the
occupancy calculator gave, the private levels and the card's nvidia-smi
name and power limit.
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
LAYOUTS = ((128, 1), (64, 2), (32, 4))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_k6_layouts: no CUDA device available", file=sys.stderr)
        return 1
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.ops.cuda import mlp_kernel, train_kernel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = tt.load_config(str(ROOT / "data" / "config_hash.json"))
    gen = torch.Generator().manual_seed(1234)
    chosen = train_kernel.K6_LAYOUT
    for label, enc in (("config_hash", {}),
                       ("reference T=2^19", {"log2_hashmap_size": 19, "per_level_scale": 2.0})):
        c = json.loads(json.dumps(cfg))
        c["encoding"].update(enc)
        m = tt.create_from_config(2, 3, c, seed=1234, device="cuda")
        tr, net = m.trainer, m.network
        p = tr.params.detach().clone()
        n_net = net.network.n_params
        p[n_net:] = (torch.rand(p.numel() - n_net, generator=gen) * 2 - 1).cuda()
        x = torch.rand(B, 2, generator=gen).cuda()
        t = torch.rand(B, 3, generator=gen).cuda()
        prep = train_kernel.prepare_forward(net, p)
        _, want = train_kernel._fused_train_grads_plain(
            prep.plan, prep.dims, net.encoding.active_levels(), prep.table, prep.weights,
            tr.loss_fn, x, t, tr.loss_scale, None, None, False)
        want = want.double()

        def step():
            return train_kernel.fused_train_grads(net, tr.loss_fn, p, x, t, tr.loss_scale)[1]

        ms = {str(lay): [] for lay in LAYOUTS}
        err, plan, blocks = {}, {}, {}
        for _ in range(2):
            for lay in LAYOUTS:
                train_kernel.K6_LAYOUT = lay
                nt, n_private, priv = train_kernel.train_layout(net)
                plan[str(lay)] = {"nt": nt, "private_levels": n_private,
                                  "smem_bytes": mlp_kernel.bwd_smem_bytes(prep.dims, nt,
                                                                          priv_floats=priv)}
                blocks[str(lay)] = mlp_kernel.persistent_grid(
                    "tcnn_fused_train_grid", (B, prep.plan.f, priv, nt, *prep.dims.c_args()),
                    x.device)
                got = step().double()
                err[str(lay)] = {
                    part: float(torch.linalg.vector_norm(got[s] - want[s])
                                / torch.linalg.vector_norm(want[s]))
                    for part, s in (("weights", slice(0, n_net)), ("table", slice(n_net, None)))}
                for _ in range(3):
                    step()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(ITERS):
                    step()
                end.record()
                torch.cuda.synchronize()
                ms[str(lay)].append(start.elapsed_time(end) / ITERS)
        train_kernel.K6_LAYOUT = chosen
        print(json.dumps({"config": label, "B": B, "card": smi,
                          "k6_ms": {k: min(v) for k, v in ms.items()}, "turns_ms": ms,
                          "layout": plan, "grid_blocks": blocks, "norm_rel_err": err}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
