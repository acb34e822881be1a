#!/usr/bin/env python3
"""CPU rehearsal of chip_smoke.py's phase 17 on the plain twins: its control
flow at a small size, or the loss falls that set its limits.

    python scripts/rehearse_optimizers_slice.py flow [LOG2_B]
    python scripts/rehearse_optimizers_slice.py limits [LOG2_B] [WHICH ...]

flow: `optimizers_slice` end to end on the CPU at B = 2^LOG2_B (default 12;
the SDF variants at a quarter of it) with 4 steps a path, the card's
`torch.cuda` calls stubbed and its times 0. Every check runs; those that
only a card can pass (a kernel's launch count, K3's operand builds, the
loss falls of 4 steps, (e)'s step gradient, whose "card" model takes the
CPU's f32 plain route, (f)'s K14 launches, which the CPU's twin does not
count) print "CHECK FAILED" and the run goes on.

limits: the training loops of paths (a) the NeRF chain, (c) Shampoo and (e)
the f32 Trainer at B = 2^LOG2_B (default 18, the card's) with the card's
step counts and routes (`chip_smoke.card_route`: the f32 Trainer's twins of
K1, K2, K5 and K4), on config_hash and the synthetic 1024^2 image, and (d)
"route": each A2 variant of the SDF sample's HashGrid (ROUTE_VARIANTS) at
the card's B_SDF and N_ROUTE_STEPS over ROUTE_DRAWS seeded draws (the
card's model seeds first); prints the first loss, the mean of the last ten
and their ratio for each (WHICH: any of chain, shampoo, f32, route;
default all).
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import tcnn_tpu_torch as tt  # noqa: E402
from tcnn_tpu_torch.utils.image import sample_image, synthetic_image  # noqa: E402


def batches(B, seed=cs.SEED):
    image = synthetic_image(1024, 1024, device="cpu")
    gen = torch.Generator().manual_seed(seed)

    def batch(n=B):
        x = torch.rand(n, 2, generator=gen)
        return x, sample_image(image, x)

    return batch


def stub_card():
    """The card's calls as no-ops, times 0, failed checks printed."""
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.set_sync_debug_mode = lambda *a, **k: None
    cs.cuda_ms = lambda fn, iters: (fn(), 0.0)[1]
    cs.kernel_device_ms = lambda fn, key, iters=10: (fn(), (0.0, 0.0))[1]

    def check(cond, what):
        if not cond:
            print(f"CHECK FAILED: {what}", flush=True)

    cs.check = check


def flow(log2_b: int) -> None:
    stub_card()
    cs.B_MAIN, cs.B_SDF = 1 << log2_b, 1 << max(log2_b - 2, 10)
    cs.N_CHAIN_STEPS = cs.N_SHAMPOO_STEPS = cs.N_ROUTE_STEPS = cs.N_F32_STEPS = 4
    cs.N_K14_STEPS = 4
    cfg = tt.load_config(str(ROOT / "data" / "config_hash.json"))
    t0 = time.perf_counter()
    launches, k14 = cs.optimizers_slice(cfg, "cpu", "cpu (rehearsal)", batches(cs.B_MAIN))
    print(json.dumps({"rehearsal": "flow", "launches": launches, "K14": k14,
                      "seconds": time.perf_counter() - t0}))


ROUTE_DRAWS = 4


def route_limits() -> None:
    """(d)'s loss falls: each variant over ROUTE_DRAWS draws (model and
    batch seeds), the first draw at the card's model seeds."""
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    for draw in range(ROUTE_DRAWS):
        gen = torch.Generator().manual_seed(cs.SEED + 65 + 100 * draw)
        for i, variant in enumerate(cs.ROUTE_VARIANTS):
            tr = cs.route_model(variant, cs.SEED + 66 + i + 100 * draw, "cpu").trainer
            t0 = time.perf_counter()
            losses = torch.stack([sdf.train_step(tr, torch.rand(cs.B_SDF, 3, generator=gen))
                                  for _ in range(cs.N_ROUTE_STEPS)])
            print(json.dumps({"rehearsal": "route", "variant": variant, "draw": draw,
                              "steps": cs.N_ROUTE_STEPS, "B": cs.B_SDF,
                              "loss_first": float(losses[0]),
                              "loss_last10_mean": float(losses[-10:].mean()),
                              "loss_fall": float(losses[0] / losses[-10:].mean()),
                              "seconds": time.perf_counter() - t0}), flush=True)


def limits(log2_b: int, which) -> None:
    cfg = tt.load_config(str(ROOT / "data" / "config_hash.json"))
    B = 1 << log2_b
    runs = {"chain": (cs.NERF_OPTIMIZER, cs.N_CHAIN_STEPS, torch.bfloat16),
            "shampoo": (cs.SHAMPOO_OPTIMIZER, cs.N_SHAMPOO_STEPS, torch.bfloat16),
            "f32": (cfg["optimizer"], cs.N_F32_STEPS, torch.float32)}
    for name in which or [*runs, "route"]:
        if name == "route":
            route_limits()
            continue
        optimizer, steps, dtype = runs[name]
        net = tt.create_network_with_input_encoding(2, 3, cfg["encoding"], cfg["network"])
        tr = tt.Trainer(net, tt.create_optimizer(optimizer), tt.create_loss(cfg["loss"]),
                        seed=cs.SEED, device="cpu", compute_dtype=dtype)
        batch = batches(B)
        t0 = time.perf_counter()
        with cs.card_route():
            losses = torch.stack([tr.training_step(*batch()) for _ in range(steps)])
        print(json.dumps({"rehearsal": name, "steps": steps, "B": B,
                          "loss_first": float(losses[0]),
                          "loss_last10_mean": float(losses[-10:].mean()),
                          "loss_fall": float(losses[0] / losses[-10:].mean()),
                          "seconds": time.perf_counter() - t0}), flush=True)


def main() -> None:
    what = sys.argv[1]
    if what == "flow":
        flow(int(sys.argv[2]) if len(sys.argv) > 2 else 12)
    else:
        limits(int(sys.argv[2]) if len(sys.argv) > 2 else 18, sys.argv[3:])


if __name__ == "__main__":
    main()
