"""Volume rendering over ragged rays, for training a NeRF (instant-ngp's
`compute_loss_kernel_train_nerf`, testbed_nerf.cu, without its occupancy
grid and early termination).

A batch holds the samples of many rays back to back: ray r owns samples
offsets[r] to offsets[r + 1] - 1 of the flat batch, each with its step
dt. Per sample i of ray r, from the density sigma_i and colour c_i:

    alpha_i = 1 - exp(-sigma_i dt_i),  T_i = exp(-sum_{j<i} sigma_j dt_j)
    C_r = sum_i T_i alpha_i c_i + T_end(r) background_r

The per-ray sums come from running sums over the whole flat batch in
float64, differenced at the offsets: no loop over rays, and a sum over
2^20 samples keeps each ray's own sums to float32's precision. It is all
plain torch operations; the loss's gradient is written out in the same
(`_RayLossFn`), and `composite` alone is differentiable by autograd.

The loss is instant-ngp's Huber (`loss_and_gradient`, testbed_nerf.cu):
huber(prediction - target, delta=0.1) / 5 per channel, summed over the
three channels and averaged over the rays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

#: instant-ngp's Huber: huber_loss(target, prediction, 0.1f) / 5.0f
HUBER_DELTA = 0.1
HUBER_DIVISOR = 5.0


class Rays(NamedTuple):
    """The rays' layout of a flat batch of samples, the targets of
    `Trainer.training_step` for a ray loss.

    offsets     int64 [R + 1], 0 first and the batch's size last, rising
    dt          f32 [B], each sample's step along its ray
    background  f32 [R, 3], each ray's background colour
    rgb         f32 [R, 3], each ray's target colour
    """

    offsets: torch.Tensor
    dt: torch.Tensor
    background: torch.Tensor
    rgb: torch.Tensor

    @property
    def n_rays(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def n_samples(self) -> int:
        return self.dt.shape[0]

    def ray_of_sample(self) -> torch.Tensor:
        """int64 [B]: each sample's ray, the number of rays that end at or
        before it (no device read)."""
        samples = torch.arange(self.n_samples, device=self.offsets.device)
        return torch.searchsorted(self.offsets[1:], samples, right=True)


def _running_sum(values: torch.Tensor) -> torch.Tensor:
    """float64 [n + 1]: 0, then the running sum of `values` flattened in
    row-major order to n elements. One flat scan: torch's scan along the
    outer dim of [2^20, 3] took 0.35 s on an H100."""
    flat = values.to(torch.float64, memory_format=torch.contiguous_format).reshape(-1)
    return F.pad(torch.cumsum(flat, 0), (1, 0))


def transmittance(tau: torch.Tensor, rays: Rays, ray: torch.Tensor):
    """(T f32 [B], T_end f32 [R]) of the optical depths tau [B]: each
    sample's transmittance before it, each ray's after its last sample;
    `ray` is `rays.ray_of_sample()`."""
    acc = _running_sum(tau)
    bounds = acc.index_select(0, rays.offsets)
    start = bounds[:-1]
    t = torch.exp(-(acc[:-1] - start.index_select(0, ray)).float())
    return t, torch.exp(-(bounds[1:] - start).float())


def _ray_sums(values: torch.Tensor, rays: Rays) -> torch.Tensor:
    """f32 [R, 3]: each ray's sum of `values` [B, 3], channel by channel in
    one flat scan of [3, B]: channel k's samples s to e - 1 sum to
    acc[k B + e] - acc[k B + s]."""
    acc = _running_sum(values.t())
    channels = torch.arange(3, device=values.device)[:, None] * rays.n_samples
    at = acc.index_select(0, (rays.offsets[None, :] + channels).reshape(-1)).view(3, -1)
    return (at[:, 1:] - at[:, :-1]).t().float()


def _composite(rgb, sigma, rays: Rays, ray):
    """(colour f32 [R, 3], (T, exp(-tau), w) f32 [B] each, T_end f32 [R])."""
    tau = sigma * rays.dt
    t, t_end = transmittance(tau, rays, ray)
    e = torch.exp(-tau)
    w = t * (1.0 - e)
    colour = _ray_sums(w[:, None] * rgb, rays) + t_end[:, None] * rays.background
    return colour, (t, e, w), t_end


def composite(rgb: torch.Tensor, sigma: torch.Tensor, rays: Rays) -> torch.Tensor:
    """f32 [R, 3]: each ray's colour from its samples' colours rgb [B, 3]
    and densities sigma [B], over its background; differentiable by
    autograd."""
    return _composite(rgb, sigma, rays, rays.ray_of_sample())[0]


def huber(prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """instant-ngp's Huber per element: 0.5 / delta d^2 inside delta,
    |d| - 0.5 delta outside, over 5."""
    d = prediction - target
    a = d.abs()
    inside = (0.5 / HUBER_DELTA) * d * d
    return torch.where(a > HUBER_DELTA, a - 0.5 * HUBER_DELTA, inside) / HUBER_DIVISOR


class _RayLossFn(torch.autograd.Function):
    """The Huber ray loss of raw colours [B, 3] and raw densities [B], its
    gradient written out (autograd's of the same forward runs about twice
    the operators, ~75 against ~35, each with its host cost). With
    g_C = dL/dC per ray,
    per sample i of ray r: dL/dc_i = w_i g_C, dL/dw_i = c_i . g_C, and
    dL/dtau_i = dL/dw_i T_i exp(-tau_i) - sum_{k > i in r} dL/dw_k w_k
    - (background_r . g_C) T_end(r), the sum over later samples again a
    running sum over the flat batch."""

    @staticmethod
    def forward(ctx, rgb_raw, density_raw, offsets, dt, background, target):
        rays = Rays(offsets, dt, background, target)
        ray = rays.ray_of_sample()
        c = torch.sigmoid(rgb_raw.float())
        sigma = torch.exp(density_raw.float())
        colour, (t, e, w), t_end = _composite(c, sigma, rays, ray)
        d = colour - target
        ctx.save_for_backward(c, sigma, t, e, w, t_end, d, ray, offsets, dt, background)
        ctx.dtypes = (rgb_raw.dtype, density_raw.dtype)
        return huber(colour, target).sum() / rays.n_rays

    @staticmethod
    def backward(ctx, grad):
        c, sigma, t, e, w, t_end, d, ray, offsets, dt, background = ctx.saved_tensors
        slope = torch.where(d.abs() > HUBER_DELTA, torch.sign(d), d / HUBER_DELTA)
        g_colour = slope * (grad / (HUBER_DIVISOR * d.shape[0]))
        g_sample = g_colour.index_select(0, ray)
        g_w = (c * g_sample).sum(1)
        acc = _running_sum(g_w * w)
        later = acc.index_select(0, offsets[1:]).index_select(0, ray) - acc[1:]
        g_end = ((background * g_colour).sum(1) * t_end).index_select(0, ray)
        g_tau = g_w * t * e - later.float() - g_end
        g_rgb = w[:, None] * g_sample * c * (1.0 - c)
        return (g_rgb.to(ctx.dtypes[0]), (g_tau * dt * sigma).to(ctx.dtypes[1]),
                None, None, None, None)


class RayLoss:
    """A NeRF's loss over ragged rays: each sample's raw colour [B, 3] and
    raw density [B] through instant-ngp's activations (sigmoid colour,
    exponential density), composited per ray, then `otype`'s loss against
    each ray's target, summed over the channels and averaged over the
    rays. Only "Huber", base.json's."""

    OTYPES = ("Huber",)

    def __init__(self, otype: str = "Huber"):
        if str(otype).lower() != "huber":
            raise ValueError(f"the ray loss holds {self.OTYPES}, not {otype!r}")
        self.otype = "Huber"

    def __call__(self, rgb_raw: torch.Tensor, density_raw: torch.Tensor, rays: Rays) -> torch.Tensor:
        """The loss, a 0-d f32 tensor, differentiable in both raw inputs."""
        return _RayLossFn.apply(rgb_raw, density_raw, *rays)

    def hyperparams(self):
        return {"otype": self.otype}

    def __repr__(self):
        return f"RayLoss({self.otype!r})"
