"""Instant-NGP's NeRF network (instant-ngp's nerf_network.h, `NerfNetwork`),
and its training step over ragged rays.

Per sample, input [B, 6]: a position p in [0, 1]^3, then a direction d
stored as (d + 1) / 2.

    h   = density_network(pos_encoding(p))       [B, 16], no activation
    rgb = rgb_network([h ; dir_encoding(d)])     [B, 16], 3 used

The output [B, 16] holds rgb's raw columns 0-2 and h's first column, the
raw density, in column 3 (nerf_network.h's `extract_density`); the other
columns are rgb's padding. The flat parameter vector is laid out
[density network | rgb network | position encoding | direction encoding]
(`NerfNetwork::set_params_impl`), so the matrices come first and Adam's
matrix/non-matrix split holds. With base.json the position encoding is a
3-D hash grid (K1 forward, K4 backward), both networks FullyFusedMLPs (K2,
K5) and the direction encoding spherical harmonics in torch. The fused
kernels K3 and K6 take one grid and one MLP, so `train_kernel.supported`
and `fused_plan_for` refuse this model: it trains on the composed route
and infers through `apply`.
"""

from __future__ import annotations

import torch

from ..common import COMPUTE_DTYPE
from ..utils import profiling
from .base import Network

#: instant-ngp's NeRF sample: 3 position and 3 direction dims; the density
#: network's output width when its config sets none; rgb's real outputs
N_POS_DIMS = 3
N_DENSITY_OUTPUTS = 16
N_RGB = 3


class NerfNetwork(Network):
    def __init__(self, pos_encoding, density_network, dir_encoding, rgb_network):
        """Built by `config.create_nerf_network` from the config's blocks:
        `density_network` takes the position encoding's padded width,
        `rgb_network` the density network's padded outputs and then the
        direction encoding's, each a multiple of 16 wide."""
        self.pos_encoding = pos_encoding
        self.density_network = density_network
        self.dir_encoding = dir_encoding
        self.rgb_network = rgb_network
        super().__init__(N_POS_DIMS + dir_encoding.n_dims_to_encode, N_RGB + 1)

    @property
    def padded_output_width(self) -> int:
        return self.rgb_network.padded_output_width

    def _parts(self):
        return (self.density_network, self.rgb_network, self.pos_encoding, self.dir_encoding)

    @property
    def n_params(self) -> int:
        return sum(p.n_params for p in self._parts())

    def layer_sizes(self):
        return self.density_network.layer_sizes() + self.rgb_network.layer_sizes()

    def split_params(self, params):
        """The four slices of the flat vector, in its order: one split,
        whose backward writes the flat gradient in one pass (four slices
        would each fill a zero vector of every parameter)."""
        return torch.split(params, [part.n_params for part in self._parts()])

    def init_params(self, generator: torch.Generator) -> torch.Tensor:
        return torch.cat([p.init_params(generator) for p in self._parts()])

    def fields(self, params, x, compute_dtype=COMPUTE_DTYPE):
        """(rgb network's output, density network's output), each [B, 16]
        in `compute_dtype`, of samples x [B, 6]; differentiable with
        respect to `params`."""
        dens_p, rgb_p, pos_p, dir_p = self.split_params(params)
        enc = self.pos_encoding.apply(pos_p, x[:, :N_POS_DIMS].contiguous(), compute_dtype=compute_dtype)
        h = self.density_network.apply(dens_p, enc, compute_dtype=compute_dtype)
        d = self.dir_encoding.apply(dir_p, x[:, N_POS_DIMS:], compute_dtype=compute_dtype)
        return self.rgb_network.apply(rgb_p, torch.cat([h, d], 1), compute_dtype=compute_dtype), h

    def apply(self, params, x, *, compute_dtype=COMPUTE_DTYPE):
        """[B, 6] -> [B, padded_output_width] in `compute_dtype`,
        differentiable with respect to `params`."""
        rgb, h = self.fields(params, x, compute_dtype)
        return torch.cat([rgb[:, :N_RGB], h[:, :1], rgb[:, N_RGB + 1 :]], 1)

    def hyperparams(self):
        return {
            "otype": "NerfNetwork",
            "encoding": self.pos_encoding.hyperparams(),
            "network": self.density_network.hyperparams(),
            "dir_encoding": self.dir_encoding.hyperparams(),
            "rgb_network": self.rgb_network.hyperparams(),
        }


def train_grads(model, loss, params, inputs, rays, loss_scale: float, compute_dtype):
    """(loss, f32 gradient of the flat params times `loss_scale`) of one
    step over ragged rays: one forward of the fields (span
    "tcnn.nerf.fields"), the ray loss (span "tcnn.nerf.composite"), one
    backward into the flat gradient (span "tcnn.nerf.backward"). Counts
    "nerf.rays" and "nerf.samples" once a step."""
    if rays.n_samples != inputs.shape[0]:
        raise ValueError(f"{inputs.shape[0]} samples, but the rays lay out {rays.n_samples}")
    profiling.count("nerf.rays", rays.n_rays)
    profiling.count("nerf.samples", rays.n_samples)
    p = params.detach().requires_grad_(True)
    with torch.enable_grad():
        with profiling.span("tcnn.nerf.fields"):
            rgb, h = model.fields(p, inputs, compute_dtype)
        with profiling.span("tcnn.nerf.composite"):
            total = loss(rgb[:, :N_RGB], h[:, 0], rays)
        with profiling.span("tcnn.nerf.backward"):
            (grads,) = torch.autograd.grad(loss_scale * total, p)
    return total.detach(), grads
