"""Plain PyTorch reference of Instant-NGP's NeRF training step, written from
the published descriptions (Mueller et al., "Instant Neural Graphics
Primitives", SIGGRAPH 2022; instant-ngp's nerf_network.h and
testbed_nerf.cu; tiny-cuda-nn's spherical_harmonics.h). It imports nothing
of the program under test: the layout, the compositing and the chain are
worked out here again, on `field.py`'s grid, MLP and Adam.

Per sample of a ray, from a position p in [0, 1]^3 and a direction stored
as (d + 1) / 2:
  h = density MLP(HashGrid(p)) [16];  sigma = exp(h_0)
  c = sigmoid(colour MLP([h ; SH_4(d)])[0:3])
and per ray, its samples in order with steps dt:
  alpha_i = 1 - exp(-sigma_i dt_i),  T_i = exp(-sum_{j<i} sigma_j dt_j)
  C = sum_i T_i alpha_i c_i + T_end background
  loss = mean over rays of sum over channels of huber(C - target, 0.1) / 5

The rays are laid into a dense [rays, longest] block, padding with no
density, and each ray's sums run along its own row, in float32 with TF32
off (`field.strict_f32`). The flat vector is [density MLP | colour MLP |
grid table]. `precision` rounds as `field.Field`'s does: "fp8" is the
control.

The optimizer is the chain of instant-ngp's configs/nerf/base.json: EMA
(decay) of the weights after ExponentialDecay's scaled Adam step, Adam
being tiny-cuda-nn's (`field.TcnnAdam`).
"""

from __future__ import annotations

import torch

from .field import ALIGN, HashGrid, Mlp, Rounding, TcnnAdam, next_multiple

DENSITY_OUTPUTS = 16
SH_OUTPUTS = 16
HUBER_DELTA = 0.1
HUBER_DIVISOR = 5.0


def sh4(d: torch.Tensor) -> torch.Tensor:
    """f32 [N, 16]: the real spherical harmonics of degree 4 of unit
    vectors d [N, 3], tiny-cuda-nn's polynomial table (sh_enc in
    common_device.h)."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xy, xz, yz, x2, y2, z2 = x * y, x * z, y * z, x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * x2 - 0.54627421529603959 * y2,
        0.59004358992664352 * y * (-3.0 * x2 + y2),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2),
    ], 1)


def _check_directions(cfg: dict) -> None:
    """The direction encoding must be a degree-4 SphericalHarmonics on the
    3 direction dims (base.json: a Composite whose other nested encoding
    gets none)."""
    enc = cfg["dir_encoding"]
    nested = enc.get("nested", [enc]) if enc.get("otype") == "Composite" else [enc]
    sh = [n for n in nested if n.get("otype") == "SphericalHarmonics"]
    if len(sh) != 1 or int(sh[0].get("degree", 4)) != 4:
        raise ValueError("the reference holds a degree-4 SphericalHarmonics direction encoding")


class Nerf:
    """The fields of a NeRF config over one flat parameter vector."""

    def __init__(self, cfg: dict, precision: str = "f32"):
        self.cfg = cfg
        _check_directions(cfg)
        self.grid = HashGrid(3, cfg["encoding"])
        self.density = Mlp(self.grid.width, DENSITY_OUTPUTS, cfg["network"])
        self.colour = Mlp(next_multiple(DENSITY_OUTPUTS, ALIGN) + SH_OUTPUTS, 3, cfg["rgb_network"])
        self.n_matrix = self.density.n_params + self.colour.n_params
        self.n_params = self.n_matrix + self.grid.n_params
        self.rnd = Rounding(precision)

    def leaves(self):
        """(name, begin, end): each matrix of both MLPs, each grid level."""
        d = [(f"density.{n}", b, e) for n, b, e in self.density.leaves()]
        c = [(f"colour.{n}", b + self.density.n_params, e + self.density.n_params)
             for n, b, e in self.colour.leaves()]
        return d + c + self.grid.leaves(self.n_matrix)

    def fields(self, params: torch.Tensor, x: torch.Tensor):
        """(colour f32 [N, 3], density f32 [N]) of samples x [N, 6]."""
        nd = self.density.n_params
        enc = self.rnd(self.grid.encode(params[self.n_matrix :], x[:, :3], self.rnd))
        h = self.density.apply(params[:nd], enc, self.rnd)
        sh = self.rnd(sh4(x[:, 3:6] * 2.0 - 1.0))
        raw = self.colour.apply(params[nd : self.n_matrix], torch.cat([h, sh], 1), self.rnd)
        return torch.sigmoid(raw), torch.exp(h[:, 0])


def composite(colour, sigma, dt, offsets, background) -> torch.Tensor:
    """f32 [R, 3]: each ray's colour, its samples laid into a dense block."""
    lengths = offsets[1:] - offsets[:-1]
    n_rays, longest = lengths.shape[0], int(lengths.max())
    ray = torch.repeat_interleave(torch.arange(n_rays, device=dt.device), lengths)
    col = torch.arange(dt.shape[0], device=dt.device) - offsets[:-1][ray]
    tau = torch.zeros(n_rays, longest, device=dt.device).index_put((ray, col), sigma * dt)
    rgb = torch.zeros(n_rays, longest, 3, device=dt.device).index_put((ray, col), colour)
    alpha = 1.0 - torch.exp(-tau)
    before = torch.cumsum(tau, 1) - tau
    weight = torch.exp(-before) * alpha
    return (weight[..., None] * rgb).sum(1) + torch.exp(-tau.sum(1))[:, None] * background


def huber(pred, target) -> torch.Tensor:
    d = pred - target
    return torch.where(d.abs() > HUBER_DELTA, d.abs() - 0.5 * HUBER_DELTA,
                       0.5 / HUBER_DELTA * d * d) / HUBER_DIVISOR


def loss(nerf: Nerf, params, batch) -> torch.Tensor:
    """The step's loss on `batch` = (x [B, 6], offsets [R + 1], dt [B],
    background [R, 3], target [R, 3])."""
    x, offsets, dt, background, target = batch
    colour, sigma = nerf.fields(params, x)
    pred = composite(colour, sigma, dt, offsets, background)
    return huber(pred, target).sum() / target.shape[0]


class Chain:
    """EMA(decay) of ExponentialDecay(start, interval, base) of Adam: the
    lr is Adam's times base^k, k the decays due at or before the step
    count before the step; EMA's average is decay * avg + (1 - decay) * w
    after each step, from zero."""

    def __init__(self, cfg: dict, n_params: int, n_matrix: int, device):
        if cfg.get("otype", "").lower() != "ema" or cfg["nested"].get("otype") != "ExponentialDecay":
            raise ValueError("the reference holds the chain Ema -> ExponentialDecay -> Adam")
        self.decay = float(cfg.get("decay", 0.99))
        dec = cfg["nested"]
        self.start = int(dec.get("decay_start", 10000))
        self.interval = int(dec.get("decay_interval", 10000))
        self.end = int(dec.get("decay_end", 10000000))
        self.base = float(dec.get("decay_base", 0.1))
        self.adam = TcnnAdam(dec["nested"], n_params, n_matrix, device)
        self.lr = self.adam.lr
        self.factor = 1.0
        self.steps = 0
        self.average = torch.zeros(n_params, device=device)

    def step(self, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        t = self.steps
        if self.start <= t <= self.end and (t - self.start) % self.interval == 0:
            self.factor *= self.base
        self.adam.lr = self.lr * self.factor
        w = self.adam.step(w, g)
        self.average = self.decay * self.average + (1.0 - self.decay) * w
        self.steps += 1
        return w

    def first_gradient(self) -> torch.Tensor:
        return self.adam.first_gradient()


def initial_params(nerf: Nerf, seed: int, table_scale: float, device) -> torch.Tensor:
    """Seeded f32 weights: U(-1, 1) over the whole vector from a generator
    on the device, each matrix scaled to its Xavier bound, the table to
    `table_scale`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(nerf.n_params, generator=gen, device=device) * 2.0 - 1.0
    scale = torch.full((nerf.n_params,), float(table_scale), device=device)
    off = 0
    for mlp in (nerf.density, nerf.colour):
        for (_, b, e), s in zip(mlp.leaves(), mlp.init_scales()):
            scale[off + b : off + e] = s
        off += mlp.n_params
    return u * scale

