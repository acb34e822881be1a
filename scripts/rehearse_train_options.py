#!/usr/bin/env python3
"""CPU rehearsal of config_hash's training with stochastic interpolation
and/or the Rng hash, in either package, to set the loss and PSNR limits of
chip_smoke.py's phase 13 before it runs on a GPU.

    python scripts/rehearse_train_options.py torch|jax OPTION [STEPS] [LOG2_B]

OPTION is stochastic, rng or both. Both packages train data/config_hash.json
from init on the synthetic 1024^2 image of tcnn_tpu_torch.utils.image (the
targets are sampled with torch and handed to JAX as numpy arrays), on the
same seeded batches; the port runs its plain twins, tcnn_tpu its XLA route.
Prints one JSON line: the first loss, the mean of the last ten, their ratio
and the PSNR of `trainer.inference` on 2^16 held-out points.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tcnn_tpu_torch.utils.image import psnr, sample_image, synthetic_image  # noqa: E402

OPTIONS = {"stochastic": {"stochastic_interpolation": True}, "rng": {"hash": "Rng"},
           "both": {"stochastic_interpolation": True, "hash": "Rng"}}


def main() -> None:
    package, option = sys.argv[1], sys.argv[2]
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 100
    batch = 1 << (int(sys.argv[4]) if len(sys.argv) > 4 else 16)
    cfg = json.loads((ROOT / "data" / "config_hash.json").read_text())
    cfg["encoding"].update(OPTIONS[option])
    image = synthetic_image(1024, 1024, device="cpu")
    gen = torch.Generator().manual_seed(1234)
    batches = [torch.rand(batch, 2, generator=gen) for _ in range(steps)]
    held = torch.rand(1 << 16, 2, generator=gen)
    t0 = time.perf_counter()
    if package == "torch":
        import tcnn_tpu_torch as tt

        tr = tt.create_from_config(2, 3, cfg, seed=1234, device="cpu").trainer
        losses = [float(tr.training_step(x, sample_image(image, x))) for x in batches]
        pred = tr.inference(held)
    else:
        import jax.numpy as jnp

        import tcnn_tpu as tc

        tr = tc.create_from_config(2, 3, cfg).trainer
        losses = [float(tr.training_step(jnp.asarray(x.numpy()),
                                         jnp.asarray(sample_image(image, x).numpy())))
                  for x in batches]
        pred = torch.from_numpy(__import__("numpy").asarray(tr.inference(jnp.asarray(held.numpy()))))
    last10 = sum(losses[-10:]) / 10
    print(json.dumps({"package": package, "option": option, "steps": steps, "B": batch,
                      "loss_first": losses[0], "loss_last10_mean": last10,
                      "loss_fall": losses[0] / last10,
                      "holdout_psnr_db": psnr(pred[:, :3], sample_image(image, held)),
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
