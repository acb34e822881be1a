#!/usr/bin/env python3
"""K5's error against its plain twin over many seeded draws at the PPNG
sample shapes (MLP input width 48 for PPNG1, 16 for PPNG2), on one CUDA
GPU, with the package and chip_smoke.py helpers of the checkout given:

    python3 scripts/k5_error_draws.py [CHECKOUT]

CHECKOUT (default: the checkout holding this script) is built and run as
it is, so two checkouts (for example a parent unpacked with `git archive`)
read the same 24 draws a variant: chip_smoke.py phase 10's sample model
(`ppng_model`, seed 1000 + draw) at B = 2^16, with the SDF data term's loss
cotangent. Prints one JSON line per draw: gW's and gx's norm-relative
error (chip_smoke.py's K5_REL bounds them by 1e-4 and 1e-3), the rows of gx
that differ and the largest difference in a row. Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else __file__).resolve()
if ROOT.is_file():
    ROOT = ROOT.parents[1]
sys.path.insert(0, str(ROOT))

DRAWS = 24


def nre(a, b) -> float:
    import torch

    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k5_error_draws: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tcnn_tpu_torch.ops.cuda import mlp_kernel
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    dev = torch.device("cuda", 0)
    for variant in ("PPNG1", "PPNG2"):
        for draw in range(DRAWS):
            gen = torch.Generator().manual_seed(1000 + draw)
            pm = cs.ppng_model(variant, cs.SEED + 12, gen, dev,
                               encoding=dict(sdf.ENCODINGS[variant]))
            net, params = pm.network, pm.trainer.params
            x = torch.rand(cs.B_SDF, 3, generator=gen).to(dev)
            dims = net.network.dims
            net_p, enc_p = net.split_params(params)
            enc = net.encoding.apply(enc_p, x)
            weights = net_p.to(torch.bfloat16).contiguous()
            gout = cs.loss_cotangent(dims, weights, enc, pm.loss, sdf.sdf_true(x)[:, None],
                                     pm.trainer.loss_scale)
            pw, px = mlp_kernel._mlp_backward_plain(dims, weights, enc, gout)
            gw, gx = mlp_kernel.mlp_backward(dims, weights, enc, gout)
            torch.cuda.synchronize()
            rows = (gx.float() - px.float()).abs().amax(dim=1)
            print(json.dumps({"checkout": str(ROOT), "variant": variant, "draw": draw,
                              "gW": nre(gw, pw), "gx": nre(gx, px),
                              "rows_off": int((rows > 0).sum()),
                              "worst_row": float(rows.max())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
