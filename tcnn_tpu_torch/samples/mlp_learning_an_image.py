"""Learn an image: (x, y) -> RGB with a grid + MLP model (counterpart of
``samples/mlp_learning_an_image.py``, the reference's
samples/mlp_learning_an_image.cu by intent).

    python -m tcnn_tpu_torch.samples.mlp_learning_an_image [image] [config.json] \\
        [n_steps] [output] [device] [--native-pipeline]

Each step draws 2^18 uniform coordinates on the device (a torch.Generator
seeded 1337) and their bilinear targets (`sample_image`); the loss is
printed at exponentially spaced steps with steps/s and samples/s; the
trained model renders the pixel-center lattice through `trainer.inference`
in chunks of 2^20, and the PSNR against the image is printed before the
render is written. The config defaults to data/config_hash.json; the image
to the reference's albert.jpg where data/images/albert.jpg exists, else a
synthetic 1024 x 1024 pattern. The device defaults to the card.

The reference-default config (`log2_hashmap_size` 19, `per_level_scale`
2.0, README.md of tiny-cuda-nn) trains here through the fused train kernel
K6 and renders through K3, as config_hash does: the kernels read any table
size. The JAX package trains it on its composed route (its fused kernels
refuse tables past their one-hot cap), which rounds the gradient to bf16
at every layer where K6 keeps it at f32 precision; set
`trainer.use_fused_train_kernel = False` for the port's composed route
(K1 K2 K5 K4).

`--native-pipeline` takes the batches from the native host runtime
instead (`tcnn_tpu_torch.native`, as the JAX sample's flag does): each step
`HostRng(1337).image_batch` draws the reference demo's PCG32 coordinate
stream and samples the image bilinearly on the host; the batch is copied
into pinned memory and goes to the card with a non-blocking copy. The flag
demands the native library and raises when it cannot be built.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

from ..config import create_from_config, load_config
from ..native import HostRng
from ..utils.profiling import StepTimer
from ..utils.image import (
    load_image,
    pixel_center_coords,
    psnr,
    sample_image,
    save_image,
    synthetic_image,
)

ROOT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_CONFIG = ROOT / "data" / "config_hash.json"
REFERENCE_IMAGE = ROOT / "data" / "images" / "albert.jpg"
BATCH = 1 << 18
RENDER_CHUNK = 1 << 20
SEED = 1337


def device_batches(image: torch.Tensor, batch: int, device: torch.device):
    """Batches drawn on `device`: uniform coordinates from a generator
    seeded SEED and their bilinear targets."""
    image = image.to(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    while True:
        x = torch.rand(batch, 2, generator=gen, device=device)
        yield x, sample_image(image, x)


def native_batches(image: torch.Tensor, batch: int, device: torch.device):
    """Batches from the native host runtime: `HostRng(SEED).image_batch`
    (the reference demo's PCG32 stream, sampled on the host), copied to
    `device` through pinned memory without blocking. Raises when the
    native library cannot be built."""
    rng = HostRng(SEED, use_native=True)
    host_image = np.ascontiguousarray(image.cpu().numpy(), np.float32)
    while True:
        xy, rgb = (torch.from_numpy(a) for a in rng.image_batch(host_image, batch))
        if device.type == "cuda":
            # the caching host allocator keeps a pinned block until its copy ends
            xy, rgb = (t.pin_memory().to(device, non_blocking=True) for t in (xy, rgb))
        yield xy, rgb


def train(config: dict, image: torch.Tensor, n_steps: int, device="cuda", batch: int = BATCH,
          log=print, pipeline=device_batches):
    """Create the model of `config` on `device` and train it `n_steps`
    steps on `image` [H, W, 3], each on a batch of `pipeline(image, batch,
    device)` (`device_batches` or `native_batches`). Returns (model, the
    losses f32 [n_steps] on the CPU). `log` gets the progress lines (None:
    silent)."""
    model = create_from_config(2, 3, config, device=device)
    trainer = model.trainer
    batches = pipeline(image, batch, trainer.device)
    losses = []
    interval = 10
    timer = StepTimer(batch)
    for step in range(1, n_steps + 1):
        losses.append(timer.step(trainer.training_step(*next(batches))))
        if log is not None and (step % interval == 0 or step == n_steps):
            dt = timer.seconds()  # synchronises
            log(f"step {step}: loss {float(losses[-1]):.6e} ({step / dt:.1f} steps/s, "
                f"{step * batch / dt / 1e6:.1f} Msamples/s)")
            if step // interval == 10:
                interval *= 10
    return model, torch.stack(losses).cpu() if losses else torch.zeros(0)


@torch.no_grad()
def render(trainer, height: int, width: int, chunk: int = RENDER_CHUNK) -> torch.Tensor:
    """The model's prediction f32 [H, W, 3] at the pixel centers, through
    `trainer.inference` on chunks of `chunk` coordinates."""
    xy = pixel_center_coords(height, width, device=trainer.device)
    out = [trainer.inference(xy[i : i + chunk]) for i in range(0, xy.shape[0], chunk)]
    return torch.cat(out).reshape(height, width, 3)


def main(argv) -> int:
    pipeline = native_batches if "--native-pipeline" in argv else device_batches
    args = [a for a in argv[1:] if not a.startswith("--")]
    image_path = args[0] if len(args) > 0 else None
    config_path = args[1] if len(args) > 1 else str(DEFAULT_CONFIG)
    n_steps = int(args[2]) if len(args) > 2 else 10_000
    out_path = args[3] if len(args) > 3 else "out.jpg"
    device = args[4] if len(args) > 4 else "cuda"

    if image_path:
        image = load_image(image_path)
    elif REFERENCE_IMAGE.exists():
        image = load_image(str(REFERENCE_IMAGE))
    else:
        image = synthetic_image(1024, 1024, device="cpu")
    h, w = image.shape[:2]
    print(f"image {w}x{h}; config {config_path}; {n_steps} steps")
    model, _ = train(load_config(config_path), image, n_steps, device=device, pipeline=pipeline)
    print(f"model: {model.network.n_params} params on {model.trainer.device}")
    pred = render(model.trainer, h, w)
    print(f"final PSNR {psnr(pred, image.to(pred.device)):.2f} dB")
    save_image(out_path, pred)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
