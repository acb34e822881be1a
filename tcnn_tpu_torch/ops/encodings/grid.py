"""Multiresolution (hash/tiled/dense) grid encoding - Instant-NGP.

Counterpart of ``tcnn_tpu/ops/encodings/grid.py`` (the reference's
GridEncodingTemplated, grid.h:652-1210): the same offset table, uint32
index math with wraparound, +0.5 level staggering, hash-only-when-the-level-
overflows rule and max_level mask (a scalar, or one value per sample). The
forward runs through kernel K1 on a CUDA tensor and through its plain twin
on a CPU tensor (``ops/cuda/grid_kernel.py``); both read a bf16 copy of the
table, as the JAX package's Pallas kernel does. With `needs_input_grad` the
output is differentiable with respect to x as well, to second order (K7 and
K8), under the JAX package's conditions (grid.py:316-356).

The cases those conditions leave out - Nearest, stochastic interpolation,
a max_level clamp (scalar or per sample) and `"fast_input_grads": false` -
take the plain differentiable route, as the JAX package sends them to its
XLA autodiff route (`_apply_xla`, grid.py:393-443): an f32 gather from the
f32 table, the interpolation weights, the corner sum and the max_level mask,
in torch on any device, differentiable by autograd to any order (Nearest
gives dL/dx = 0). At compute dtype f32 a CUDA tensor keeps the kernels,
their bf16 output cast to f32, as the JAX package keeps its Pallas kernels
on a TPU; a CPU tensor takes the plain route, as the JAX package takes XLA
off a TPU (`common.plain_route`).

Stochastic interpolation only changes the table gradient (grid.h:284-299):
each (sample, level) sends its whole gradient row to one corner, drawn from
`stochastic_uniforms` (K4's and K6's stochastic option; off under Nearest,
as in the JAX package's Pallas plan). On the plain route its forward is the
exact interpolation and dL/dx goes through it (`_apply_stochastic`,
grid.py:476-529). `HashType.Rng` hashes through the PCG32 advance
(``ops/pcg32.py``; in every grid kernel and on the plain route).

Large tables take the same kernels. The JAX package sends the trailing
levels of a table past its dense kernels' cap (the reference-default
T=2^19 among them) to a binned counting sort (``tcnn_tpu/ops/pallas/
binned_kernel.py``: bin, gather, combine, place, scatter, combine_ig,
combine_bwdbwd), which exists because the TPU cannot gather per lane from a
large table. Here K1 (and K3, K6's gather) computes its combine's function,
K4 (and K6's scatter) its place + scatter's, K7 (and K9) its combine_ig's
and K8 its combine_bwdbwd's, reading and scattering any table size
directly. The binned route drops a pick on slot overflow; these kernels
drop none.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F_

from ... import common
from ...common import (
    COMPUTE_DTYPE,
    GridType,
    HashType,
    InterpolationType,
    MAX_N_LEVELS,
    next_multiple,
)
from .. import threefry
from ..cuda import grid_kernel
from .base import Encoding


def grid_scale(level: int, log2_per_level_scale: float, base_resolution: int) -> float:
    """exp2(level*log2(s)) * base - 1 (common_device.h:709-714)."""
    return float(np.exp2(level * log2_per_level_scale) * base_resolution - 1.0)


def grid_resolution(scale: float) -> int:
    return int(np.ceil(scale)) + 1


def stochastic_uniforms(batch: int, n_levels: int, device="cuda", seed: int = grid_kernel.SEED):
    """f32 [batch, n_levels]: the per-(sample, level) uniforms that choose
    stochastic interpolation's scatter corner (grid.h:287: random_val(1337,
    ...), shared across dims), bit-equal to the JAX package's
    ``jax.random.uniform(PRNGKey(1337), (batch, n_levels))``
    (``ops/threefry.py``). Element (b, l) depends on b * n_levels + l alone,
    so a row's draws do not depend on the batch size."""
    index = torch.arange(batch * n_levels, dtype=torch.int64, device=device)
    return threefry.uniform_at(index, seed).reshape(batch, n_levels)


def per_sample(max_level) -> bool:
    """Whether `max_level` holds one value per sample (an array or tensor
    [B]) rather than one for the batch."""
    if isinstance(max_level, torch.Tensor):
        return max_level.dim() > 0
    return np.ndim(max_level) > 0


class GridEncoding(Encoding):
    """Trainable multiresolution feature grid (hash / tiled / dense)."""

    pad_value = 0.0  # grid zero-pads (grid.h:749-759)
    #: takes `needs_input_grad` (NetworkWithInputEncoding passes it)
    supports_input_grad_opt = True

    def __init__(
        self,
        n_dims_to_encode: int,
        n_levels: int = 16,
        n_features_per_level: int = 2,
        log2_hashmap_size: int = 19,
        base_resolution: int = 16,
        per_level_scale: float = 2.0,
        grid_type: GridType = GridType.Hash,
        hash_type: HashType = HashType.CoherentPrime,
        interpolation: InterpolationType = InterpolationType.Linear,
        stochastic_interpolation: bool = False,
        max_level=None,
        fast_input_grads: bool = True,
    ):
        if n_dims_to_encode not in (2, 3, 4):
            raise ValueError("GridEncoding supports 2, 3, or 4 input dims")
        if n_features_per_level not in (1, 2, 4, 8):
            raise ValueError("n_features_per_level must be 1, 2, 4, or 8")
        if n_levels > MAX_N_LEVELS:
            raise ValueError(f"n_levels must be <= {MAX_N_LEVELS}")
        super().__init__(n_dims_to_encode)

        self.n_levels = int(n_levels)
        self.n_features_per_level = int(n_features_per_level)
        self.log2_hashmap_size = int(log2_hashmap_size)
        self.base_resolution = int(base_resolution)
        self.per_level_scale = float(per_level_scale)
        self.grid_type = grid_type
        self.hash_type = hash_type
        self.interpolation = interpolation
        self.stochastic_interpolation = bool(stochastic_interpolation)
        #: coarse-to-fine clamp in [0, 1], a scalar or one value per sample;
        #: None = no clamping (grid_interface.h:101-123)
        self.max_level = max_level
        #: input gradients through the kernels K7/K8 (the JAX package's
        #: "fast_input_grads" extension key, default on)
        self.fast_input_grads = bool(fast_input_grads)

        # Offset table (grid.h:685-730): per-level sizes, 8-aligned, capped by
        # grid type; all in units of feature *vectors* (not scalars).
        log2_scale = math.log2(self.per_level_scale)
        max_params = 2**31  # uint32_max / 2
        offsets, sizes, resolutions, scales = [], [], [], []
        offset = 0
        d = self.n_dims_to_encode
        for lvl in range(self.n_levels):
            s = grid_scale(lvl, log2_scale, self.base_resolution)
            res = grid_resolution(s)
            params_in_level = max_params if float(res) ** d > max_params else res**d
            params_in_level = next_multiple(params_in_level, 8)
            if grid_type == GridType.Tiled:
                params_in_level = min(params_in_level, self.base_resolution**d)
            elif grid_type == GridType.Hash:
                params_in_level = min(params_in_level, 1 << self.log2_hashmap_size)
            offsets.append(offset)
            sizes.append(params_in_level)
            resolutions.append(res)
            scales.append(s)
            offset += params_in_level

        self._offsets = np.asarray(offsets, dtype=np.uint32)
        self._sizes = np.asarray(sizes, dtype=np.uint32)
        self._resolutions = np.asarray(resolutions, dtype=np.uint32)
        self._scales = np.asarray(scales, dtype=np.float32)
        self._total_table_rows = offset

    @functools.cached_property
    def plan(self) -> grid_kernel.GridPlan:
        """The explicit layout the grid kernels (K1, K3, K4, K6) run from."""
        return grid_kernel.GridPlan(self)

    # -- shape / params -----------------------------------------------------
    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def n_params(self) -> int:
        return self._total_table_rows * self.n_features_per_level

    def init_params(self, generator: torch.Generator) -> torch.Tensor:
        # U(-1e-4, 1e-4) (grid.h:1059-1062)
        return torch.empty(self.n_params, dtype=torch.float32).uniform_(
            -1e-4, 1e-4, generator=generator
        )

    # -- indexing -----------------------------------------------------------
    def _grid_indices(self, cells_u32: torch.Tensor) -> torch.Tensor:
        """Per-level table row index for integer grid cells.

        cells_u32: int64 [..., L, C, D] holding uint32 cells. Returns int64
        [..., L, C] row index *within* each level's table (before the level
        offset), as grid_index (common_device.h:690-707) computes it,
        including the uint32-wrapping stride loop and its early exit."""
        strides, hashed_levels, sizes, _, _ = self.plan.index_consts(cells_u32.device)
        return grid_kernel.index_within_level(cells_u32, strides, hashed_levels,
                                              self.plan.hash_fn(), sizes)

    def count_binned_drops(self, x) -> int:
        """Picks of `x` the encoding drops: always 0. The JAX package's
        binned route (grid.py:208-221) drops a (sample, corner, level) pick
        when more distinct rows than a slab slot's cap land in one
        superblock; the port's kernels gather and scatter every row
        directly and drop nothing, so the JAX config key that warns on
        drops ("warn_binned_drops") has nothing to warn of and is ignored."""
        return 0

    def active_levels(self, max_level=None) -> int:
        """Levels kept by a scalar max_level clamp: level l survives when
        l < max_level * L + 1e-3, in float32 (grid.h:69-92)."""
        ml = max_level if max_level is not None else self.max_level
        L = self.n_levels
        if ml is None:
            return L
        if per_sample(ml):
            raise ValueError("a per-sample max_level keeps no single number of levels")
        bound = np.float32(ml) * np.float32(L) + np.float32(1e-3)
        return int(np.sum(np.arange(L, dtype=np.float32) < bound))

    def _mask_max_level(self, y, ml):
        """Zero each sample's levels l >= max_level[b] * L + 1e-3 (f32) of
        the encoded [B, >= L*F] output, as tcnn_tpu's `_mask_max_level`
        (grid.py:381-391) does after the kernel; padding columns stay."""
        B, L, F = y.shape[0], self.n_levels, self.n_features_per_level
        lvl = torch.arange(L, dtype=torch.float32, device=y.device)
        if per_sample(ml):
            ml = torch.as_tensor(ml, dtype=torch.float32, device=y.device).reshape(-1, 1)
            bound = ml * L + 1e-3
        else:  # the same f32 bound, computed on the host: no copy to the device
            bound = float(np.float32(ml) * np.float32(L) + np.float32(1e-3))
        keep = (lvl[None, :] < bound).expand(B, L).repeat_interleave(F, dim=1)
        pad = torch.ones((B, y.shape[1] - L * F), dtype=torch.bool, device=y.device)
        return torch.where(torch.cat([keep, pad], 1), y, torch.zeros((), dtype=y.dtype, device=y.device))

    def _kernels_refuse_input_grads(self, ml) -> bool:
        """Whether the input-gradient kernels leave this encoding to the
        plain route (the JAX package's choice, grid.py:316-356)."""
        return (not self.fast_input_grads or self.interpolation == InterpolationType.Nearest
                or self.stochastic_interpolation or ml is not None)

    # -- the plain differentiable route --------------------------------------
    def interpolate_f32(self, params, x, ml=None):
        """f32 [B, L*F]: what tcnn_tpu's `_apply_xla` computes
        (grid.py:393-443) from the f32 table `params`, the levels past the
        max_level clamp `ml` zeroed; differentiable in params and x by
        autograd, to any order (K1's corner walk, `grid_kernel._corners`)."""
        table = params.reshape(self.plan.total_rows, self.n_features_per_level)
        out = sum(k.w[..., None] * table[k.rows] for k in grid_kernel._corners(self.plan, x))
        y = out.reshape(x.shape[0], self.n_output_dims)
        return y if ml is None else self._mask_max_level(y, ml)

    def _encode_plain(self, params, x, out_width: int, ml, needs_input_grad: bool,
                      compute_dtype):
        if self.plan.stochastic:
            y = _StochasticGridFn.apply(params, x, self, ml, needs_input_grad, compute_dtype)
        else:
            y = self.interpolate_f32(params, x, ml).to(compute_dtype)
        return F_.pad(y, (0, out_width - y.shape[1]))

    # -- forward ------------------------------------------------------------
    def _encode(self, params, x, out_width: int, max_level, needs_input_grad: bool,
                compute_dtype=COMPUTE_DTYPE):
        ml = max_level if max_level is not None else self.max_level
        if common.plain_route(x, compute_dtype) or (
                needs_input_grad and self._kernels_refuse_input_grads(ml)):
            return self._encode_plain(params, x, out_width, ml, needs_input_grad, compute_dtype)
        if needs_input_grad:
            return grid_kernel.GridIgFn.apply(params, x, self.plan, out_width).to(compute_dtype)
        if x.requires_grad:
            raise NotImplementedError(
                "x requires a gradient: ask for input gradients with needs_input_grad=True "
                "(NetworkWithInputEncoding.apply(..., prepare_input_gradients=True))"
            )
        if ml is not None and per_sample(ml):
            y = grid_kernel.GridEncodeFn.apply(params, x, self.plan, out_width, self.n_levels)
            return self._mask_max_level(y, ml).to(compute_dtype)
        return grid_kernel.GridEncodeFn.apply(
            params, x, self.plan, out_width, self.active_levels(ml)).to(compute_dtype)

    def apply_unpadded(self, params, x, *, max_level=None, needs_input_grad=False,
                       compute_dtype=COMPUTE_DTYPE):
        """x: [B, D] fp32 in (roughly) [0, 1]^D -> [B, L*F] in
        `compute_dtype` (bf16 by default), level-major, feature-minor
        (grid.h:146-148). With `needs_input_grad`, the output is
        differentiable with respect to x as well, to second order (K1, then
        K7, then K8, or the plain route); max_level may be a scalar or one
        value per sample [B]."""
        return self._encode(params, x, self.n_output_dims, max_level, needs_input_grad,
                            compute_dtype)

    def apply(self, params, x, *, max_level=None, needs_input_grad=False,
              compute_dtype=COMPUTE_DTYPE):
        """Encode straight into the padded width: the kernel writes the zero
        padding columns itself (grid.py:445-449)."""
        return self._encode(params, x, self.padded_output_width, max_level, needs_input_grad,
                            compute_dtype)

    # -- config echo ----------------------------------------------------------
    def hyperparams(self):
        return {
            "otype": "Grid",
            "type": self.grid_type.value,
            "n_levels": self.n_levels,
            "n_features_per_level": self.n_features_per_level,
            "log2_hashmap_size": self.log2_hashmap_size,
            "base_resolution": self.base_resolution,
            "per_level_scale": self.per_level_scale,
            "interpolation": self.interpolation.value,
            "hash": self.hash_type.value,
            "stochastic_interpolation": self.stochastic_interpolation,
        }

    def update_hyperparams(self, params: dict) -> None:
        if "max_level" in params:
            self.max_level = params["max_level"]


class _StochasticGridFn(torch.autograd.Function):
    """Stochastic interpolation on the plain route (tcnn_tpu's
    `_apply_stochastic`, grid.py:476-529): the forward is the exact
    interpolation; the table gradient sends each (sample, level)'s f32
    gradient row whole to the corner `grid_kernel.stochastic_rows` draws
    (none past the max_level clamp); dL/dx is the exact interpolation's,
    or 0 without `needs_input_grad`. The backward is torch code on the
    saved inputs, so it differentiates again."""

    @staticmethod
    def forward(ctx, params, x, enc, ml, needs_input_grad, compute_dtype):
        ctx.save_for_backward(params, x)
        ctx.enc, ctx.ml, ctx.needs_ig = enc, ml, needs_input_grad
        return enc.interpolate_f32(params, x, ml).to(compute_dtype)

    @staticmethod
    def backward(ctx, gy):
        params, x = ctx.saved_tensors
        enc, ml = ctx.enc, ctx.ml
        B, L, F = x.shape[0], enc.n_levels, enc.n_features_per_level
        g = gy.float().reshape(B, L, F)
        if ml is not None:
            g = enc._mask_max_level(g.reshape(B, L * F), ml).reshape(B, L, F)
        rows = grid_kernel.stochastic_rows(enc.plan, x.detach()).reshape(-1)
        gtable = torch.zeros((enc.plan.total_rows, F), dtype=torch.float32, device=x.device)
        gtable = gtable.index_add(0, rows, g.reshape(B * L, F)).reshape(-1)
        gx = None
        if ctx.needs_input_grad[1]:
            if ctx.needs_ig:
                create_graph = torch.is_grad_enabled()
                with torch.enable_grad():
                    y = enc.interpolate_f32(params, x, ml)
                    (gx,) = torch.autograd.grad(y, x, gy.float(), create_graph=create_graph)
            else:
                gx = torch.zeros_like(x)
        return gtable, gx, None, None, None, None
