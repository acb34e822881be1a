#!/usr/bin/env python3
"""CPU rehearsal of chip_smoke.py's phase 16 on the plain twins, to set the
limits of its paths (a) and (b) before they run on a GPU.

    python scripts/rehearse_modules_slice.py oneblob [STEPS] [LOG2_B] [SEED]
    python scripts/rehearse_modules_slice.py modules [STEPS] [LOG2_B] [SEED]

oneblob: data/config_oneblob.json (OneBlob 64 bins, FullyFusedMLP 128 x 5)
trains through the image sample's `train` on the synthetic 1024^2 image
(the composed route: K2 and K5's twins), then the holdout PSNR of
`trainer.inference` on 2^16 seeded points. modules: the module-API sample
on data/config_hash.json (`torch.optim.Adam`, the sample's relative L2)
trains on the same image, then the PSNR of its render over every pixel.
SEED (default 1337, the samples' own) seeds the training batches' draws,
to see how far the limits' quantities spread between draws. Prints one
JSON line: the first loss, the mean of the last ten, their ratio, the
quality and the seconds taken.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import tcnn_tpu_torch as tt  # noqa: E402
from tcnn_tpu_torch.samples import mlp_learning_an_image as sample  # noqa: E402
from tcnn_tpu_torch.samples import mlp_learning_an_image_modules as modules_sample  # noqa: E402
from tcnn_tpu_torch.utils.image import psnr, sample_image, synthetic_image  # noqa: E402


def holdout_psnr(trainer, image, seed=1234, n=1 << 16):
    """PSNR of `trainer.inference` on n seeded points against the image's
    bilinear samples there (chip_smoke.py's phase 16 draws its own)."""
    x = torch.rand(n, 2, generator=torch.Generator().manual_seed(seed)).to(trainer.device)
    return psnr(trainer.inference(x), sample_image(image.to(trainer.device), x))


def main() -> None:
    what = sys.argv[1]
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    seed = int(sys.argv[4]) if len(sys.argv) > 4 else 1337
    sample.SEED = modules_sample.SEED = seed
    image = synthetic_image(1024, 1024, device="cpu")
    t0 = time.perf_counter()
    if what == "oneblob":
        batch = 1 << (int(sys.argv[3]) if len(sys.argv) > 3 else 14)
        cfg = tt.load_config(str(ROOT / "data" / "config_oneblob.json"))
        model, losses = sample.train(cfg, image, steps, device="cpu", batch=batch, log=None)
        quality = {"holdout_psnr_db": holdout_psnr(model.trainer, image)}
    else:
        batch = 1 << (int(sys.argv[3]) if len(sys.argv) > 3 else 16)
        module = modules_sample.create_module(
            tt.load_config(str(ROOT / "data" / "config_hash.json")), device="cpu")
        losses = modules_sample.train(module, image, steps, batch=batch, log=None)
        quality = {"render_psnr_db": psnr(modules_sample.render(module, 1024, 1024), image)}
    print(json.dumps({"what": what, "steps": steps, "B": batch, "seed": seed,
                      "loss_first": float(losses[0]),
                      "loss_last10_mean": float(losses[-10:].mean()),
                      "loss_fall": float(losses[0] / losses[-10:].mean()), **quality,
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
