"""Inputs made from a run's seed, on the device, in a few large calls.

Each stream of a run draws from its own generator, seeded from the run's
seed and the stream's number, so that the image, the batches and the
views do not depend on one another's sizes (the weights draw from the
seed itself, `reference.field.initial_params`). The bilinear fetch is the
reference demo's texture fetch (tiny-cuda-nn samples/mlp_learning_an_image.cu:
linear filtering, pixel centres at (i + 0.5) / size, edges clamped), as the
port's image sample draws its batches.
"""

from __future__ import annotations

import math

import torch

IMAGE, BATCHES, VIEWS = 1, 2, 3


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 8 + stream) % (1 << 63))


def synthetic_image(seed: int, size: int, device, components: int = 8) -> torch.Tensor:
    """f32 [size, size, 3] in [0, 1]: per channel the mean of `components`
    plane waves of random direction, frequency (1 to 64 cycles) and phase."""
    gen = generator(seed, IMAGE, device)
    r = torch.rand(3, components, 4, generator=gen, device=device)
    freq = 1.0 + 63.0 * r[..., 0] ** 2
    angle = 2 * math.pi * r[..., 1]
    phase = 2 * math.pi * r[..., 2]
    t = (torch.arange(size, device=device, dtype=torch.float32) + 0.5) / size
    v, u = torch.meshgrid(t, t, indexing="ij")
    arg = (2 * math.pi * freq[..., None, None]
           * (torch.cos(angle)[..., None, None] * u + torch.sin(angle)[..., None, None] * v)
           + phase[..., None, None])
    return (0.5 + 0.5 * torch.sin(arg).mean(1)).permute(1, 2, 0).contiguous()


def sample_image(image: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch of `image` [H, W, C] at normalised `xy` [..., 2]."""
    h, w = image.shape[0], image.shape[1]
    fx = xy[..., 0] * w - 0.5
    fy = xy[..., 1] * h - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = (fx - x0)[..., None], (fy - y0)[..., None]
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)

    def at(yi, xi):
        return image[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]

    top = at(y0, x0) * (1 - tx) + at(y0, x0 + 1) * tx
    bot = at(y0 + 1, x0) * (1 - tx) + at(y0 + 1, x0 + 1) * tx
    return top * (1 - ty) + bot * ty


def image_ring(seed: int, batch: int, ring: int, image_size: int, device, halves: bool = False):
    """(x f32 [ring, batch, 2] uniform in [0, 1), y f32 [ring, batch, 3]
    their bilinear targets) from a seeded synthetic image. With `halves`,
    each batch draws its first half at x < 0.5 and its second at x >= 0.5
    from the same numbers: still uniform over the image as a whole
    (stratified), and a step that drops half of its batch drops half of
    the image."""
    image = synthetic_image(seed, image_size, device)
    x = torch.rand(ring, batch, 2, generator=generator(seed, BATCHES, device), device=device)
    if halves:
        n = batch // 2
        x[:, :n, 0] *= 0.5
        x[:, n:, 0] = 0.5 + 0.5 * x[:, n:, 0]
    return x, sample_image(image, x)


def point_ring(seed: int, batch: int, ring: int, dims: int, device) -> torch.Tensor:
    """f32 [ring, batch, dims] uniform in [0, 1)."""
    return torch.rand(ring, batch, dims, generator=generator(seed, BATCHES, device), device=device)


def views(seed: int, n_views: int, height: int, width: int, zoom: tuple, device) -> torch.Tensor:
    """f32 [n_views, height * width, 2]: each view the pixel centres of a
    height x width frame over a window of the unit square, zoomed by a
    factor drawn in [zoom[0], zoom[1]] and panned to a uniform place inside
    the square, row-major."""
    r = torch.rand(n_views, 3, generator=generator(seed, VIEWS, device), device=device)
    z = zoom[0] + (zoom[1] - zoom[0]) * r[:, 0]
    span_x = 1.0 / z
    span_y = span_x * (height / width)
    ox, oy = (1.0 - span_x) * r[:, 1], (1.0 - span_y) * r[:, 2]
    u = (torch.arange(width, device=device, dtype=torch.float32) + 0.5) / width
    v = (torch.arange(height, device=device, dtype=torch.float32) + 0.5) / height
    gx = ox[:, None, None] + span_x[:, None, None] * u[None, None, :]
    gy = oy[:, None, None] + span_y[:, None, None] * v[None, :, None]
    gx, gy = torch.broadcast_tensors(gx, gy)
    return torch.stack([gx, gy], -1).reshape(n_views, height * width, 2).contiguous()
