"""Learn an image through the module API (counterpart of
``samples/mlp_learning_an_image_modules.py``, the reference's
samples/mlp_learning_an_image_pytorch.py by intent).

    python -m tcnn_tpu_torch.samples.mlp_learning_an_image_modules [image] \\
        [config.json] [n_steps] [output] [device]

The same image regression as ``mlp_learning_an_image``, driven only
through `tcnn_tpu_torch.NetworkWithInputEncoding` (a `torch.nn.Module`)
with an external `torch.optim.Adam(lr=1e-2, betas=(0.9, 0.99), eps=1e-15)`
and the sample's own relative L2 loss, so only the config's "encoding" and
"network" blocks are read. First one `fwd` / `bwd` call on 512 points,
which returns the parameter and the input gradients (a grid + FullyFusedMLP
module runs K3 forward and K9 backward there); then `n_steps` steps of
batch 2^16, each drawing uniform coordinates and their bilinear targets on
the device (K1 -> K2 forward, K5 -> K4 backward under autograd); then a
render of the pixel-center lattice through the module in 2^20-pixel chunks
and its PSNR. The config defaults to data/config_hash.json; the image to
the reference's albert.jpg where data/images/albert.jpg exists, else a
synthetic 512 x 512 pattern; the device to the card.
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np
import torch

from ..config import load_config
from ..modules import NetworkWithInputEncoding
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
BATCH = 1 << 16
N_DEMO = 512
RENDER_CHUNK = 1 << 20
SEED = 1337


def relative_l2(y, targets):
    """The reference sample's loss (mlp_learning_an_image_pytorch.py:109):
    (y - t)^2 / (sg(y)^2 + 0.01), mean-reduced."""
    return torch.mean((y - targets) ** 2 / (y.detach() ** 2 + 0.01))


def create_module(config: dict, device="cuda") -> NetworkWithInputEncoding:
    return NetworkWithInputEncoding(2, 3, config["encoding"], config["network"], device=device)


def demo(module, image: torch.Tensor):
    """One `fwd` / `bwd` call on N_DEMO seeded points with the L2 loss's
    gradient: returns (dL/dparams, dL/dx)."""
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(N_DEMO, 2)).astype(np.float32))
    x = x.to(module.device)
    y, ctx = module.fwd(x)
    dL_dy = 2.0 * (y - sample_image(image, x)) / y.numel()
    return module.bwd(ctx, dL_dy)


def train(module, image: torch.Tensor, n_steps: int, batch: int = BATCH, log=print):
    """`n_steps` steps of torch.optim.Adam on `module`; returns the losses
    f32 [n_steps] on the CPU. `log` gets the progress lines (None: silent)."""
    opt = torch.optim.Adam(module.parameters(), lr=1e-2, betas=(0.9, 0.99), eps=1e-15)
    gen = torch.Generator(device=module.device).manual_seed(SEED)
    losses, interval, t0 = [], 10, time.perf_counter()
    for step in range(1, n_steps + 1):
        x = torch.rand(batch, 2, generator=gen, device=module.device)
        loss = relative_l2(module(x), sample_image(image, x))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if log is not None and (step % interval == 0 or step == n_steps):
            dt = time.perf_counter() - t0
            log(f"step {step}: loss {float(losses[-1]):.6e} ({step / dt:.1f} steps/s)")
            if step // interval == 10:
                interval *= 10
    return torch.stack(losses).cpu() if losses else torch.zeros(0)


@torch.no_grad()
def render(module, height: int, width: int, chunk: int = RENDER_CHUNK) -> torch.Tensor:
    """The module's prediction f32 [H, W, 3] at the pixel centers."""
    xy = pixel_center_coords(height, width, device=module.device)
    return torch.cat([module(xy[i : i + chunk]) for i in range(0, xy.shape[0], chunk)]
                     ).reshape(height, width, 3)


def main(argv) -> int:
    args = [a for a in argv[1:] if not a.startswith("--")]
    image_path = args[0] if len(args) > 0 else None
    config_path = args[1] if len(args) > 1 else str(DEFAULT_CONFIG)
    n_steps = int(args[2]) if len(args) > 2 else 1000
    out_path = args[3] if len(args) > 3 else "out_modules.jpg"
    device = args[4] if len(args) > 4 else "cuda"

    if image_path:
        image = load_image(image_path)
    elif REFERENCE_IMAGE.exists():
        image = load_image(str(REFERENCE_IMAGE))
    else:
        image = synthetic_image(512, 512, device="cpu")
    h, w = image.shape[:2]
    module = create_module(load_config(config_path), device=device)
    image = image.to(module.device)
    print(f"image {w}x{h}; module with {module.n_params} params, "
          f"{module.n_output_dims} outputs on {module.device}")
    dparams, dx = demo(module, image)
    print(f"fwd/bwd endpoints: |dL/dparams| sum {float(dparams.abs().sum()):.4f}, "
          f"dL/dx shape {tuple(dx.shape)}")
    train(module, image, n_steps)
    pred = render(module, h, w)
    print(f"final PSNR {psnr(pred, image):.2f} dB")
    save_image(out_path, pred)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
