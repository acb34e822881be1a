#!/usr/bin/env python3
"""CPU rehearsal of tcnn_tpu_torch at the reference-default T=2^19 hash grid,
on the plain twins, to set the limits of chip_smoke.py's phases 14 and 15
before they run on a GPU.

    python scripts/rehearse_reference_default.py image [STEPS] [LOG2_B]
    python scripts/rehearse_reference_default.py sdf [STEPS]

image: data/config_hash.json with log2_hashmap_size 19 and per_level_scale
2.0 trains through the image sample's `train` (K6's twin) on the synthetic
1024^2 image, then the sample's `render` (K3's twin) gives the PSNR over
every pixel. sdf: the SDF sample's HashGrid config with log2_hashmap_size
19 trains through its `train_step` (B = 2^16, 1024 eikonal points), then
the z = 0.5 slice error. Prints one JSON line: the first loss, the mean of
the last ten, their ratio, the quality and the seconds taken.
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
from tcnn_tpu_torch.samples import learn_a_sdf as sdf  # noqa: E402
from tcnn_tpu_torch.samples import mlp_learning_an_image as sample  # noqa: E402
from tcnn_tpu_torch.utils.image import psnr, synthetic_image  # noqa: E402


def main() -> None:
    what = sys.argv[1]
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    t0 = time.perf_counter()
    if what == "image":
        batch = 1 << (int(sys.argv[3]) if len(sys.argv) > 3 else 16)
        cfg = tt.load_config(str(ROOT / "data" / "config_hash.json"))
        cfg["encoding"].update(log2_hashmap_size=19, per_level_scale=2.0)
        image = synthetic_image(1024, 1024, device="cpu")
        model, losses = sample.train(cfg, image, steps, device="cpu", batch=batch, log=None)
        quality = {"render_psnr_db": psnr(sample.render(model.trainer, 1024, 1024), image)}
    else:
        batch = sdf.BATCH
        cfg = sdf.config("HashGrid")
        cfg["encoding"]["log2_hashmap_size"] = 19
        model = tt.create_from_config(3, 1, cfg, device="cpu")
        gen = torch.Generator().manual_seed(1234)
        losses = torch.stack([sdf.train_step(model.trainer, torch.rand(batch, 3, generator=gen))
                              for _ in range(steps)])
        quality = {"slice_error": sdf.slice_error(model.network, model.trainer.params)}
    print(json.dumps({"what": what, "steps": steps, "B": batch, "rows": model.network.encoding
                      ._total_table_rows, "loss_first": float(losses[0]),
                      "loss_last10_mean": float(losses[-10:].mean()),
                      "loss_fall": float(losses[0] / losses[-10:].mean()), **quality,
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
