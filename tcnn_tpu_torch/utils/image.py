"""Image IO and sampling for the image-fitting sample (counterpart of
``tcnn_tpu/utils/image.py``), in plain torch on any device.

`sample_image` is the reference's texture fetch (linear filtering,
normalized coordinates, edge clamping; samples/mlp_learning_an_image.cu):
bilinear at pixel centers. `load_image` and `save_image` import PIL inside
the call, so the package imports without it. The JAX package's u32 quad
packing is a TPU gather workaround and has no counterpart here.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def load_image(path: str) -> torch.Tensor:
    """An image file -> f32 [H, W, 3] in [0, 1] (sRGB values), on the CPU."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return torch.from_numpy(np.asarray(img, dtype=np.float32) / 255.0)


def save_image(path: str, img) -> None:
    """Write [H, W, 3] values in [0, 1] (a tensor on any device, or an
    array) as an 8-bit image, clipped and truncated as the JAX package
    writes it."""
    from PIL import Image

    arr = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    Image.fromarray(np.clip(arr * 255.0, 0, 255).astype(np.uint8)).save(path)


def pixel_center_coords(height: int, width: int, device="cuda") -> torch.Tensor:
    """f32 [H*W, 2] normalized (x, y) at pixel centers, row-major: the
    reference demo's evaluation lattice (mlp_learning_an_image.cu:176-189),
    ((i + 0.5) / size in f32, as the JAX package computes it)."""
    y, x = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([((x + 0.5) / width).reshape(-1), ((y + 0.5) / height).reshape(-1)], -1)


def synthetic_image(height: int = 512, width: int = 512, device="cuda") -> torch.Tensor:
    """Deterministic multi-scale test pattern [H, W, 3] f32 in [0, 1]:
    smooth gradients, rings and a high-frequency checker."""
    y, x = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    u, v = x / width, y / height
    r = torch.sqrt((u - 0.5) ** 2 + (v - 0.5) ** 2)
    red = 0.5 + 0.5 * torch.sin(40.0 * r) * torch.exp(-3 * r)
    green = 0.5 + 0.5 * torch.sin(12 * u) * torch.cos(9 * v)
    blue = torch.remainder(torch.floor(u * 32) + torch.floor(v * 32), 2) * (0.3 + 0.7 * u)
    return torch.stack([red, green, blue], -1)


def sample_image(image: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of `image` [H, W, C] at normalized coordinates `xy`
    [B, 2] (x first), edge-clamped, with pixel centers at (i + 0.5) / size."""
    h, w = image.shape[0], image.shape[1]
    fx = xy[:, 0] * w - 0.5
    fy = xy[:, 1] * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[:, None]
    ty = (fy - y0)[:, None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)

    def at(yi, xi):
        return image[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]

    top = at(y0, x0) * (1 - tx) + at(y0, x0 + 1) * tx
    bot = at(y0 + 1, x0) * (1 - tx) + at(y0 + 1, x0 + 1) * tx
    return top * (1 - ty) + bot * ty


def psnr(prediction: torch.Tensor, target: torch.Tensor) -> float:
    """Peak signal-to-noise ratio in dB of values in [0, 1] (syncs)."""
    mse = float(torch.mean((prediction.float() - target.float()) ** 2))
    return math.inf if mse == 0 else -10.0 * math.log10(mse)
