"""Multiresolution grid forward and backward: kernels K1
(``csrc/grid_fwd.cu``), K4 (``csrc/grid_bwd.cu``), K7
(``csrc/grid_bwd_ig.cu``) and K8 (``csrc/grid_bwd_bwd.cu``), their plain
PyTorch twins, and the autograd Functions that join them: `GridEncodeFn`
(table gradient only) and `GridIgFn` / `GridIgBackwardFn` (input gradients,
differentiable twice).

K1 replaces ``tcnn_tpu/ops/pallas/grid_kernel.py:_fwd_kernel`` (reached
through ``_fwd_call`` and ``grid_encode_pallas``), K4 its ``_bwd_kernel``
(through ``_bwd_call`` and ``_grid_pallas_bwd``), K7 its ``_bwd_ig_kernel``
(through ``_bwd_ig_call`` and ``_ig_backward``) and K8 its
``_bwd_bwd_kernel`` (through ``_bwd_bwd_call`` and ``_ig_backward_bwd``).
The TPU kernels gather and scatter through one-hot matmuls against a
128-lane packed table because the TPU has no per-lane random access; on
Hopper each thread owns one (sample, level), reads its 2^D corner rows
directly from a bf16 [total_rows, F] table that stays in L2, and scatters
table gradients with f32 atomics: K4 (and K6, ``train_kernel``) sum the
leading dense levels in shared memory (`private_levels`) and add the rest
with one vector atomic per corner. K1 pairs the lanes of two levels of a
sample, so that the two rows of each x-pair of corners go out in one load
instruction and share a sector fetch (``grid_level_pair``); K7 and K8 walk
the same pairs with derivatives (``pair_levels``), each lane adding the
contributions of the corners it loaded with one vector atomic a corner.
Only the bf16 rounding carries over from the TPU layout; the public column
order is the JAX package's (level-major, feature-minor). Every kernel and
twin visits the corners in one order (`_corners` here, ``grid_corners``
and K1's ``grid_level_pair`` in ``csrc/grid_common.cuh``).

Two options ride on the plan. Under `HashType.Rng` the hashed levels index
through the PCG32-advance hash (`pcg32.rng_hash`; in the kernels the device
function ``rng_hash``), where the TPU kernels read hashes precomputed outside
them only because Mosaic has no 64-bit integers. Under stochastic
interpolation the table gradient of each (sample, level) goes whole to one
corner drawn from u[b, l] (`stochastic_rows`): K4's stochastic option
replaces ``grid_kernel.py:_bwd_stoch_kernel`` (through ``_bwd_stoch_call``).

The same four kernels serve tables of any size (up to 2^31 elements).
Where the TPU table outgrows the one-hot kernels' cap (the reference-default
T=2^19), the JAX package runs the trailing levels through the binned
stages of ``tcnn_tpu/ops/pallas/binned_kernel.py``: K1 computes the
function of its ``_bin_kernel`` + ``_gather_kernel`` + ``_combine_kernel``
forward, K4 that of ``_place_kernel`` + ``_scatter_kernel`` (stochastic
corners included), K7 that of ``_combine_ig_kernel`` and K8 that of
``_combine_bwdbwd_kernel``. The binned scatter rounds each slot's f32 sum of
bf16 contributions to bf16 again (binned_kernel.py:1127-1142) and drops a
pick on slot overflow; K4 rounds each contribution once and drops nothing.

Each wrapper takes the plain twin for a CPU tensor and the kernel for a
CUDA tensor; there is no other route.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...common import GridType, HashType, InterpolationType, smoothstep
from .. import pcg32
from . import _build

U32 = 0xFFFFFFFF

# Hash factors (common_device.h:647-661). Index 0 differs per hash type:
# Prime uses 1958374283, CoherentPrime uses 1 (so dim 0 stays coherent),
# ReversedPrime is Prime's list reversed.
_PRIMES = (1958374283, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)

#: Interpolation codes the CUDA kernels take (csrc/grid_common.cuh).
INTERP_CODES = {
    InterpolationType.Nearest: 0,
    InterpolationType.Linear: 1,
    InterpolationType.Smoothstep: 2,
}
#: Hash codes the CUDA kernels take: the Prime family's factors, or Rng.
HASH_FACTORS, HASH_RNG = 0, 1
#: The seed of the Rng hash (common_device.h:663-677) and of the stochastic
#: draws (grid.h:287), which the kernels hold as constants.
SEED = 1337


def hash_factors(hash_type: HashType, n_dims: int) -> tuple:
    if hash_type == HashType.Prime:
        f = _PRIMES
    elif hash_type == HashType.CoherentPrime:
        f = (1,) + _PRIMES[1:]
    elif hash_type == HashType.ReversedPrime:
        f = tuple(reversed(_PRIMES))
    else:
        raise ValueError("HashType.Rng has no hash factors (it hashes with pcg32.rng_hash)")
    return tuple(int(v) for v in f[:n_dims])


def level_hash(hash_type: HashType, n_dims: int, seed: int = SEED):
    """The grid hash of uint32 cells int64 [..., D] -> int64 [...]
    (common_device.h:647-677): the XOR of the cells times the Prime family's
    factors, or the Rng hash with `seed`."""
    if hash_type == HashType.Rng:
        return lambda cells: pcg32.rng_hash(cells, n_dims, seed)
    factors = hash_factors(hash_type, n_dims)

    def xor_of_products(cells):
        hashed = torch.zeros_like(cells[..., 0])
        for dim in range(n_dims):
            hashed = hashed ^ mul_u32(cells[..., dim], factors[dim])
        return hashed

    return xor_of_products


def level_strides(size: int, res: int, n_dims: int):
    """The uint32-wrapping stride loop of grid_index (common_device.h:690-703)
    for one level: (per-dim strides, 0 where the dim no longer contributes;
    the final stride, which decides whether the level hashes)."""
    stride = 1
    strides = []
    for _ in range(n_dims):
        alive = stride <= size
        strides.append(stride if alive else 0)
        if alive:
            stride = (stride * res) & U32
    return tuple(strides), stride


def mul_u32(a: torch.Tensor, b) -> torch.Tensor:
    """uint32 product (mod 2^32) of int64 tensors holding uint32 values.
    `b` is split into 16-bit halves so no int64 product overflows."""
    lo = (a * (b & 0xFFFF)) & U32
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def index_within_level(cells, strides, hashed_levels, hash_fn, sizes):
    """Per-level table row of integer grid cells (grid_index,
    common_device.h:690-707), in int64 holding uint32 values.

    cells: int64 [..., L, C, D] uint32 cells; strides: int64 [L, D];
    hashed_levels: int64 [H], the levels that hash, on cells' device;
    hash_fn: `level_hash`'s function (None when no level hashes), applied
    to the hashed levels' cells only; sizes: int64 [L]. Returns int64
    [..., L, C] in [0, size)."""
    d = cells.shape[-1]
    strides = strides[:, None, :]  # [L, 1, D] broadcast over corners
    dense = torch.zeros(cells.shape[:-1], dtype=torch.int64, device=cells.device)
    for dim in range(d):
        dense = (dense + mul_u32(cells[..., dim], strides[..., dim])) & U32
    raw = dense
    if hash_fn is not None:
        raw = dense.index_copy(-2, hashed_levels, hash_fn(cells.index_select(-3, hashed_levels)))
    return raw % sizes[:, None]


def positions(x, scales, interpolation: InterpolationType, derivs: bool = False):
    """pos_fract (common_device.h:826-867): x [..., D] f32 and per-level
    scales [..., L] -> (int64 uint32 cells, f32 weights) [..., L, D], with
    pos = x * scale + 0.5 rounded after the multiply and after the add, the
    cell int32(floor(pos)) reinterpreted as uint32, and the weight the
    fraction (or its smoothstep).

    With `derivs`, also dw/dx and d2w/dx2 [..., L, D] of the weight
    (grid_kernel.py:842-848, 1008-1015): scale and 0 for Linear;
    6 t (1 - t) scale and 6 (1 - 2t) scale^2 for Smoothstep, each rounded
    after every operation in that order."""
    scale = scales[..., :, None]
    pos = x[..., None, :] * scale + 0.5
    cell_f = torch.floor(pos)
    fract = pos - cell_f
    cells = cell_f.to(torch.int32).to(torch.int64) & U32
    w = smoothstep(fract) if interpolation == InterpolationType.Smoothstep else fract
    if not derivs:
        return cells, w
    if interpolation == InterpolationType.Smoothstep:
        deriv = 6.0 * fract * (1.0 - fract) * scale
        deriv2 = 6.0 * (1.0 - 2.0 * fract) * scale * scale
    else:
        deriv = scale.expand_as(fract)
        deriv2 = torch.zeros_like(fract)
    return cells, w, deriv, deriv2


class GridPlan:
    """Everything the grid kernels need to know of a GridEncoding: per-level
    offset, size, scale, hash flag and uint32 strides, the hash type and
    factors, the interpolation, and whether the table gradient is
    stochastic (never under Nearest, as the JAX package's Pallas plan
    decides, grid_kernel.py:140-142). Built once per encoding and passed
    explicitly to every call; the per-level constants go to each device
    once, as `level_i32` [L, 8] (offset, size, use_hash, stride 0..3, 0) and
    `level_f32` [L] (scale). `hash_seed` and `draw_seed` are the seeds of
    the Rng hash and of the stochastic draws: the kernels take only 1337;
    the plain twins take any (a control hashes or draws with another)."""

    def __init__(self, enc):
        self.d = enc.n_dims_to_encode
        self.f = enc.n_features_per_level
        self.n_levels = enc.n_levels
        self.interpolation = enc.interpolation
        self.offsets = tuple(int(v) for v in enc._offsets)
        self.sizes = tuple(int(v) for v in enc._sizes)
        self.scales = np.asarray(enc._scales, np.float32)
        self.total_rows = int(enc._total_table_rows)
        strides, use_hash = [], []
        for size, res in zip(self.sizes, enc._resolutions):
            s, final = level_strides(size, int(res), self.d)
            strides.append(s)
            use_hash.append(enc.grid_type == GridType.Hash and size < final)
        self.strides = tuple(strides)
        self.use_hash = tuple(use_hash)
        self.hash_type = enc.hash_type if any(use_hash) else None
        self.hash_factors = (
            hash_factors(enc.hash_type, self.d)
            if any(use_hash) and enc.hash_type != HashType.Rng else None
        )
        self.stochastic = (enc.stochastic_interpolation
                           and enc.interpolation != InterpolationType.Nearest)
        self.hash_seed = self.draw_seed = SEED
        self._device_consts = {}
        self._index_consts = {}

    @property
    def n_corners(self) -> int:
        if self.interpolation == InterpolationType.Nearest:
            return 1
        return 1 << self.d

    @property
    def rng(self) -> bool:
        """Whether the hashed levels hash with the Rng hash."""
        return self.hash_type == HashType.Rng

    def hash_fn(self):
        """`level_hash` of the hashed levels, or None when no level hashes."""
        if self.hash_type is None:
            return None
        return level_hash(self.hash_type, self.d, self.hash_seed)

    def c_hash(self) -> tuple:
        """The hash arguments of the C entry points: four factors and the
        hash code."""
        factors = tuple(self.hash_factors or (0,) * self.d) + (0,) * (4 - self.d)
        return factors + (HASH_RNG if self.rng else HASH_FACTORS,)

    def device_consts(self, device):
        """(level_i32 [L, 8] int32, level_f32 [L] f32) on `device`."""
        if self.hash_seed != SEED or self.draw_seed != SEED:
            raise ValueError(f"the grid kernels hash and draw with seed {SEED} only")
        key = str(device)
        if key not in self._device_consts:
            li = np.zeros((self.n_levels, 8), np.int64)
            for l in range(self.n_levels):
                li[l, 0] = self.offsets[l]
                li[l, 1] = self.sizes[l]
                li[l, 2] = int(self.use_hash[l])
                li[l, 3 : 3 + self.d] = self.strides[l]
            li = li.astype(np.uint32).view(np.int32)  # uint32 bit patterns
            self._device_consts[key] = (
                torch.from_numpy(li).to(device),
                torch.from_numpy(self.scales.copy()).to(device),
            )
        return self._device_consts[key]


    def index_consts(self, device):
        """(strides int64 [L, D], the hashed levels int64 [H], sizes int64
        [L], offsets int64 [L], scales f32 [L]) on `device`, made once:
        what the twins and the plain route index with, so that they copy
        nothing to the device a call. Keyed on the fields they come from
        too, which a control's copy of the plan may change."""
        key = (str(device), self.strides, self.use_hash, self.sizes, self.offsets)
        if key not in self._index_consts:
            consts = (
                torch.tensor(self.strides, dtype=torch.int64).reshape(self.n_levels, self.d),
                torch.tensor([l for l, h in enumerate(self.use_hash) if h], dtype=torch.int64),
                torch.tensor(self.sizes, dtype=torch.int64),
                torch.tensor(self.offsets, dtype=torch.int64),
                torch.from_numpy(self.scales.copy()),
            )
            self._index_consts[key] = tuple(t.to(device) for t in consts)
        return self._index_consts[key]


class Corner(NamedTuple):
    """One corner c of every (sample, level): absolute table rows [B, L]
    int64 and the weight W_c [B, L] f32; with derivatives, dW_c/dx_d [D] and
    d2W_c/dx_d dx_d' [D][D], each [B, L] f32."""

    rows: torch.Tensor
    w: torch.Tensor
    dw: list | None = None
    d2w: list | None = None


def _rows(plan: GridPlan, cells):
    """Absolute table rows int64 [B, L] of the uint32 cells [B, L, D] (each
    int64, taken mod 2^32)."""
    strides, hashed_levels, sizes, offsets, _ = plan.index_consts(cells.device)
    idx = index_within_level((cells & U32)[:, :, None, :], strides, hashed_levels,
                             plan.hash_fn(), sizes)[..., 0]
    return offsets[None, :] + idx


def stochastic_rows(plan: GridPlan, x):
    """Absolute table rows int64 [B, L]: per (sample, level), the one
    corner that stochastic interpolation's table gradient goes to
    (grid.h:284-299): bit d of the corner is u[b, l] < w_d, with u the draw
    of `stochastic_uniforms` (seed `plan.draw_seed`) and w_d the f32 weight
    of `positions`, the forward's own."""
    from ..encodings.grid import stochastic_uniforms

    cells, w = positions(x, plan.index_consts(x.device)[4], plan.interpolation)
    u = stochastic_uniforms(x.shape[0], plan.n_levels, x.device, plan.draw_seed)
    return _rows(plan, cells + (u[..., None] < w).to(torch.int64))


def _prod(terms):
    """Left-to-right product of [B, L] factors; 1 when there are none."""
    out = None
    for t in terms:
        out = t if out is None else out * t
    return 1.0 if out is None else out


def _corners(plan: GridPlan, x, derivs: bool = False):
    """Yields a `Corner` for each corner c = 0..C-1, in the f32 position,
    cell, weight and index math of K1/K4 with one rounding per operation:
    W_c is the product over d = 0..D-1 of the per-dim terms w_d (bit set)
    or 1 - w_d (1 for Nearest). With `derivs` (K7, K8, K9), also
    dW_c/dx_d = (s_d * prod_{d' != d} term_d') * dw_d and
    d2W_c/dx_d dx_d' = ((s_d s_d' prod_{d'' not in {d, d'}} term_d'') * dw_d)
    * dw_d' for d != d', (s_d * prod_{d' != d} term_d') * d2w_d on the
    diagonal, where s_d = +1 for a set bit and -1 otherwise
    (grid_kernel.py:896-921, 1048-1057, 1125-1151)."""
    D = plan.d
    dev = x.device
    pos = positions(x, plan.index_consts(dev)[4], plan.interpolation, derivs)
    cells, w = pos[0], pos[1]  # each [B, L, D]
    nearest = plan.interpolation == InterpolationType.Nearest
    for corner in range(plan.n_corners):
        bits = [(corner >> d) & 1 for d in range(D)]
        rows = _rows(plan, torch.stack([cells[..., d] + bits[d] for d in range(D)], -1))
        if nearest:
            yield Corner(rows, 1.0 + 0.0 * w[..., 0])  # dW/dx = 0, not absent
            continue
        terms = [w[..., d] if bits[d] else 1.0 - w[..., d] for d in range(D)]
        cw = _prod(terms)
        if not derivs:
            yield Corner(rows, cw)
            continue
        deriv, deriv2 = pos[2], pos[3]
        sgn = [1.0 if b else -1.0 for b in bits]
        dw = [sgn[d] * _prod(terms[:d] + terms[d + 1 :]) * deriv[..., d] for d in range(D)]
        d2w = [
            [
                sgn[d] * _prod(terms[:d] + terms[d + 1 :]) * deriv2[..., d] if d == e
                else sgn[d] * sgn[e] * _prod([terms[k] for k in range(D) if k not in (d, e)])
                * deriv[..., d] * deriv[..., e]
                for e in range(D)
            ]
            for d in range(D)
        ]
        yield Corner(rows, cw, dw, d2w)


def _grid_encode_plain(plan: GridPlan, table, x, out_width: int, n_active: int):
    """What K1 computes, in plain PyTorch on any device: bf16 table rows
    weighted and summed over corners c = 0..C-1 in f32, one rounding to
    bf16, zeros in levels >= n_active and in the padding columns."""
    B = x.shape[0]
    L, F = plan.n_levels, plan.f
    acc = torch.zeros((B, L, F), dtype=torch.float32, device=x.device)
    for k in _corners(plan, x):
        acc = acc + table[k.rows].float() * k.w[..., None]
    acc[:, n_active:] = 0.0
    y = torch.zeros((B, out_width), dtype=torch.bfloat16, device=x.device)
    y[:, : L * F] = acc.reshape(B, L * F).to(torch.bfloat16)
    return y


def _grid_backward_plain(plan: GridPlan, x, gy, n_active: int):
    """What K4 computes, in plain PyTorch on any device: the table gradient
    f32 [total_rows, F] of the encoding's leading L*F columns of `gy`, each
    corner's contribution w_c * gy rounded to bf16 before it is summed in
    f32, as the TPU kernel rounds it (grid_kernel.py:674-677); levels
    >= n_active contribute nothing. A stochastic plan takes
    `_grid_backward_stoch_plain`."""
    if plan.stochastic:
        return _grid_backward_stoch_plain(plan, x, gy, n_active)
    B = x.shape[0]
    L, F = plan.n_levels, plan.f
    g = gy[:, : L * F].float().reshape(B, L, F)[:, :n_active]
    out = torch.zeros((plan.total_rows, F), dtype=torch.float32, device=x.device)
    for k in _corners(plan, x):
        contrib = (k.w[:, :n_active, None] * g).to(torch.bfloat16).float()
        out.index_add_(0, k.rows[:, :n_active].reshape(-1), contrib.reshape(-1, F))
    return out


def _grid_backward_stoch_plain(plan: GridPlan, x, gy, n_active: int):
    """What K4's stochastic option computes, in plain PyTorch on any
    device: each (sample, level)'s whole gy row, rounded to bf16 as the TPU
    kernel rounds it (grid_kernel.py:764-767), added in f32 into the one
    row `stochastic_rows` chose; levels >= n_active contribute nothing."""
    B = x.shape[0]
    L, F = plan.n_levels, plan.f
    g = gy[:, : L * F].float().reshape(B, L, F)[:, :n_active].to(torch.bfloat16).float()
    out = torch.zeros((plan.total_rows, F), dtype=torch.float32, device=x.device)
    rows = stochastic_rows(plan, x)[:, :n_active]
    return out.index_add_(0, rows.reshape(-1), g.reshape(-1, F))


def _fsum(terms):
    """Left-to-right sum (the kernels' order)."""
    out = None
    for t in terms:
        out = t if out is None else out + t
    return out


def _level_sum(part):
    """[B, L, D] -> [B, D], summed over levels l = 0..L-1 in order, as the
    kernels' per-sample reduction sums them."""
    return _fsum(part.unbind(1))


def _grid_input_grad_plain(plan: GridPlan, table, x, g):
    """dL/dx f32 [B, D] of the encoding for its gradient `g` [B, >= L*F]
    (values taken in f32): per (sample, level) and corner c, the dot
    sum_f table[row_c, f] * g_f times dW_c/dx_d, summed over corners
    c = 0..C-1, then over levels (grid_kernel.py:896-921)."""
    B = x.shape[0]
    L, F, D = plan.n_levels, plan.f, plan.d
    gl = g[:, : L * F].float().reshape(B, L, F)
    part = torch.zeros((B, L, D), dtype=torch.float32, device=x.device)
    for k in _corners(plan, x, derivs=True):
        feat = table[k.rows].float()
        dot = _fsum(feat[..., f] * gl[..., f] for f in range(F))
        part = part + torch.stack([dot * k.dw[d] for d in range(D)], -1)
    return _level_sum(part)


def _grid_backward_ig_plain(plan: GridPlan, table, x, gy):
    """What K7 computes, in plain PyTorch on any device: (the table
    gradient f32 [total_rows, F], as K4's twin computes it; dL/dx f32
    [B, D])."""
    return (_grid_backward_plain(plan, x, gy, plan.n_levels),
            _grid_input_grad_plain(plan, table, x, gy))


def _grid_backward_bwd_plain(plan: GridPlan, table, ct_table, x, gy, z):
    """What K8 computes, in plain PyTorch on any device: the vjp of K7's
    (gtable, gx) for the cotangents (ct_table, z) (grid_kernel.py:963-1155).
    Per corner, with zw_c = sum_d z_d dW_c/dx_d:
      ct_gy[l, f]  += table[row, f] zw_c + ct_table[row, f] W_c
      gtable2[row] += bf16(gy_f zw_c)   (scattered like K4's contributions)
      ct_x[d']     += dotf_c sum_d z_d d2W_c/dx_d dx_d' + dotf2_c dW_c/dx_d'
    where dotf_c, dotf2_c = sum_f gy_f table[row, f], ct_table[row, f].
    `ct_table` (bf16 [total_rows, F]) or `z` (f32 [B, D]) may be None: its
    terms are then skipped. Returns (ct_gy f32 [B, gy width], zeros in the
    padding; gtable2 f32 [total_rows, F]; ct_x f32 [B, D])."""
    B = x.shape[0]
    L, F, D = plan.n_levels, plan.f, plan.d
    dev = x.device
    gl = gy[:, : L * F].float().reshape(B, L, F)
    zz = None if z is None else z.float()
    ct_gy = torch.zeros((B, L, F), dtype=torch.float32, device=dev)
    part = torch.zeros((B, L, D), dtype=torch.float32, device=dev)
    gtable2 = torch.zeros((plan.total_rows, F), dtype=torch.float32, device=dev)
    for k in _corners(plan, x, derivs=True):
        cg, cx = [], [[] for _ in range(D)]
        if zz is not None:
            f1 = table[k.rows].float()
            zw = _fsum(zz[:, None, d] * k.dw[d] for d in range(D))
            cg.append(f1 * zw[..., None])
            contrib = (gl * zw[..., None]).to(torch.bfloat16).float()
            gtable2.index_add_(0, k.rows.reshape(-1), contrib.reshape(-1, F))
            dotf = _fsum(f1[..., f] * gl[..., f] for f in range(F))
            for e in range(D):
                cx[e].append(dotf * _fsum(zz[:, None, d] * k.d2w[d][e] for d in range(D)))
        if ct_table is not None:
            f2 = ct_table[k.rows].float()
            cg.append(f2 * k.w[..., None])
            dotf2 = _fsum(f2[..., f] * gl[..., f] for f in range(F))
            for e in range(D):
                cx[e].append(dotf2 * k.dw[e])
        ct_gy = ct_gy + _fsum(cg)
        part = part + torch.stack([_fsum(c) for c in cx], -1)
    out = torch.zeros((B, gy.shape[1]), dtype=torch.float32, device=dev)
    out[:, : L * F] = ct_gy.reshape(B, L * F)
    return out, gtable2, _level_sum(part)


def grid_encode(plan: GridPlan, table, x, out_width: int, n_active: int):
    """x [B, D] f32 -> [B, out_width] bf16: levels in columns
    [0, L*F), levels >= n_active zeroed, columns [L*F, out_width) zero.
    `table` is the bf16 [total_rows, F] feature table. K1 stores F columns
    at a time into rows whose width is a multiple of F, so a width that is
    not is encoded into the next multiple of F and its leading `out_width`
    columns copied out."""
    B = _check_inputs(plan, table, x)
    if out_width < plan.n_levels * plan.f:
        raise ValueError(f"out_width {out_width} < L*F = {plan.n_levels * plan.f}")
    if out_width % plan.f:
        wide = grid_encode(plan, table, x, -(-out_width // plan.f) * plan.f, n_active)
        return wide[:, :out_width].contiguous()
    if x.device.type == "cpu":
        return _grid_encode_plain(plan, table, x, out_width, n_active)
    out = torch.empty((B, out_width), dtype=torch.bfloat16, device=x.device)
    if B == 0:
        return out
    level_i32, level_f32 = plan.device_consts(x.device)
    _build.launch(
        "tcnn_grid_fwd", x.device, x.data_ptr(), table.data_ptr(), level_i32.data_ptr(),
        level_f32.data_ptr(), out.data_ptr(), B, plan.d, plan.f, plan.n_levels, int(n_active),
        INTERP_CODES[plan.interpolation], *plan.c_hash(), out_width,
    )
    return out


def _check_gy(plan: GridPlan, x, gy) -> int:
    """Checks of the encoding cotangent that K4, K7 and K8 read: [B, >= L*F],
    on x's device; on a CUDA tensor contiguous, 16-byte aligned bf16 of a
    width that is a multiple of F. Returns B."""
    B = _check_x(plan, x)
    if gy.dim() != 2 or gy.shape[0] != B or gy.shape[1] < plan.n_levels * plan.f:
        raise ValueError(f"gy must be [{B}, >= {plan.n_levels * plan.f}], got {tuple(gy.shape)}")
    if gy.device != x.device:
        raise ValueError(f"gy on {gy.device}, x on {x.device}")
    if x.device.type == "cuda":
        if gy.dtype != torch.bfloat16 or not gy.is_contiguous() or gy.data_ptr() % 16:
            raise ValueError(f"gy must be contiguous, 16-byte aligned bfloat16, got {gy.dtype}")
        if gy.shape[1] % plan.f:
            raise ValueError(f"gy's width {gy.shape[1]} must be a multiple of F = {plan.f}")
    return B


#: Shared memory a K4 block keeps its private levels' gradient in: half of
#: an SM's 233,472 bytes less the 1 KB each block reserves, so that two
#: blocks of 512 threads share an SM (config_hash: levels 0-4, 93,824
#: bytes; the reference default T=2^19: levels 0-2, 43,008 bytes). Chosen
#: by scripts/time_k4_budgets.py (H100 80GB HBM3, 700 W, B = 2^18): at
#: config_hash 0.206 ms, against 0.233 with one block an SM (levels 0-5)
#: and 0.396 with no private level; the reference default would prefer
#: one block an SM (0.296 ms against 0.326).
K4_PRIVATE_BYTES = 115_712


def private_levels(plan: GridPlan, n_active: int, spare_bytes: int) -> tuple:
    """(P, rows): the leading levels 0..P-1 whose table gradient K4 and K6
    sum in a block's shared memory, and the table rows they span (level 0
    starts at row 0, so they are rows 0..rows-1). The prefix stops at the
    first level that hashes (its ~32 adds a row gain nothing from it), that
    is past `n_active` (such levels get no gradient), or whose rows would
    take the f32 gradient (rows x F x 4 bytes) past `spare_bytes`."""
    rows = 0
    for level in range(min(n_active, plan.n_levels)):
        end = rows + plan.sizes[level]
        if plan.use_hash[level] or plan.offsets[level] != rows or end * plan.f * 4 > spare_bytes:
            return level, rows
        rows = end
    return min(n_active, plan.n_levels), rows


def grid_backward(plan: GridPlan, x, gy, n_active: int):
    """Table gradient f32 [total_rows, F] of the encoding at `x` [B, D] f32
    for the cotangent `gy` [B, >= L*F] (bf16 on a CUDA tensor; its leading
    L*F columns, level-major, are read); a stochastic plan sends each
    (sample, level)'s row to one drawn corner."""
    B = _check_gy(plan, x, gy)
    if x.device.type == "cpu":
        return _grid_backward_plain(plan, x, gy, n_active)
    dev = x.device
    out = torch.zeros((plan.total_rows, plan.f), dtype=torch.float32, device=dev)
    if B == 0 or n_active == 0:
        return out
    n_private, rows = private_levels(plan, n_active, K4_PRIVATE_BYTES)
    priv = rows * plan.f
    grid = _build.persistent_grid("tcnn_grid_bwd_grid", (B, plan.f, priv), dev)
    partials = torch.empty(grid * priv, dtype=torch.float32, device=dev)
    level_i32, level_f32 = plan.device_consts(dev)
    _build.launch(
        "tcnn_grid_bwd", dev, x.data_ptr(), gy.data_ptr(), level_i32.data_ptr(),
        level_f32.data_ptr(), out.data_ptr(), partials.data_ptr(), B, plan.d, plan.f,
        plan.n_levels, int(n_active), INTERP_CODES[plan.interpolation], *plan.c_hash(),
        int(plan.stochastic), n_private, priv, grid, gy.shape[1],
    )
    return out


def _check_ig(plan: GridPlan, table, x, gy) -> int:
    """Checks shared by K7 and K8; returns B."""
    B = _check_inputs(plan, table, x)
    _check_gy(plan, x, gy)
    if plan.interpolation == InterpolationType.Nearest:
        raise ValueError("Nearest interpolation has no input gradient kernel")
    if plan.stochastic:
        raise ValueError("stochastic interpolation has no input gradient kernel")
    return B


#: K7's and K8's blocks: at most this many warps, each serving one pair of
#: levels for 16 samples (csrc/grid_common.cuh:pair_tiles).
IG_WARPS = 16


def ig_layout(n_levels: int) -> tuple:
    """(groups, warps) of a K7 / K8 block: ceil(L / 2) level pairs, each a
    warp's task for 16 samples; `groups` groups of 16 samples a tile, so
    that groups x pairs fills IG_WARPS warps (L = 12: 2 groups, 12 warps a
    block of 32 samples); past IG_WARPS pairs the warps loop over them."""
    pairs = (n_levels + 1) // 2
    groups = max(1, IG_WARPS // pairs)
    return groups, min(IG_WARPS, groups * pairs)


def _cut_to_levels(plan: GridPlan, gy):
    """gy [B, w] cut to its leading L*F columns where w is not a multiple
    of F: K4, K7 and K8 read F columns a load, and only those columns."""
    L, F = plan.n_levels, plan.f
    if gy.dim() == 2 and gy.shape[1] % F and gy.shape[1] >= L * F:
        return gy[:, : L * F].contiguous()
    return gy


def grid_backward_ig(plan: GridPlan, table, x, gy):
    """(table gradient f32 [total_rows, F], dL/dx f32 [B, D]) of the
    encoding at `x` for the cotangent `gy` [B, >= L*F] (K7; every level
    active). `table` is the bf16 [total_rows, F] feature table."""
    gy = _cut_to_levels(plan, gy)
    B = _check_ig(plan, table, x, gy)
    if x.device.type == "cpu":
        return _grid_backward_ig_plain(plan, table, x, gy)
    dev = x.device
    gtable = torch.zeros((plan.total_rows, plan.f), dtype=torch.float32, device=dev)
    gx = torch.empty((B, plan.d), dtype=torch.float32, device=dev)
    if B == 0:
        return gtable, gx
    groups, warps = ig_layout(plan.n_levels)
    grid = _build.persistent_grid("tcnn_grid_bwd_ig_grid",
                                  (B, plan.d, plan.f, plan.n_levels, groups, warps), dev)
    level_i32, level_f32 = plan.device_consts(dev)
    _build.launch(
        "tcnn_grid_bwd_ig", dev, x.data_ptr(), gy.data_ptr(), table.data_ptr(),
        level_i32.data_ptr(), level_f32.data_ptr(), gtable.data_ptr(), gx.data_ptr(), B,
        plan.d, plan.f, plan.n_levels, INTERP_CODES[plan.interpolation], *plan.c_hash(),
        gy.shape[1], groups, warps, grid,
    )
    return gtable, gx


def grid_backward_bwd(plan: GridPlan, table, ct_table, x, gy, z):
    """(ct_gy f32 [B, gy width], gtable2 f32 [total_rows, F], ct_x f32
    [B, D]): the vjp of `grid_backward_ig` at (table, x, gy) for the
    cotangents ct_table (bf16 [total_rows, F] or None) of its table gradient
    and z (f32 [B, D] or None) of its dL/dx (K8). A None cotangent skips
    its terms, and with it K8's second gather. A gy whose width is not a
    multiple of F is cut to its L*F columns and ct_gy padded back with
    zeros."""
    cut = _cut_to_levels(plan, gy)
    ct_gy, gtable2, ct_x = _grid_backward_bwd(plan, table, ct_table, x, cut, z)
    if cut is not gy:
        ct_gy = torch.nn.functional.pad(ct_gy, (0, gy.shape[1] - cut.shape[1]))
    return ct_gy, gtable2, ct_x


def _grid_backward_bwd(plan: GridPlan, table, ct_table, x, gy, z):
    """grid_backward_bwd at a gy of whole F-column groups. The kernel
    writes ct_gy (its padding columns too) and ct_x whole; only gtable2 is
    zeroed."""
    B = _check_ig(plan, table, x, gy)
    dev = x.device
    if ct_table is not None and (ct_table.dtype != torch.bfloat16 or ct_table.shape != table.shape
                                 or ct_table.device != dev):
        raise ValueError(f"ct_table must be bfloat16 {tuple(table.shape)} on {dev}")
    if z is not None and (z.dtype != torch.float32 or tuple(z.shape) != (B, plan.d)
                          or z.device != dev):
        raise ValueError(f"z must be float32 [{B}, {plan.d}] on {dev}")
    if dev.type == "cpu":
        return _grid_backward_bwd_plain(plan, table, ct_table, x, gy, z)
    for t in (ct_table, z):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("ct_table and z must be contiguous and 16-byte aligned")
    gtable2 = torch.zeros((plan.total_rows, plan.f), dtype=torch.float32, device=dev)
    if B == 0 or (ct_table is None and z is None):
        return (torch.zeros((B, gy.shape[1]), dtype=torch.float32, device=dev), gtable2,
                torch.zeros((B, plan.d), dtype=torch.float32, device=dev))
    ct_gy = torch.empty((B, gy.shape[1]), dtype=torch.float32, device=dev)
    ct_x = torch.empty((B, plan.d), dtype=torch.float32, device=dev)
    groups, warps = ig_layout(plan.n_levels)
    grid = _build.persistent_grid("tcnn_grid_bwd_bwd_grid",
                                  (B, plan.d, plan.f, plan.n_levels, groups, warps), dev)
    level_i32, level_f32 = plan.device_consts(dev)
    _build.launch(
        "tcnn_grid_bwd_bwd", dev, x.data_ptr(), gy.data_ptr(), 0 if z is None else z.data_ptr(),
        table.data_ptr(), 0 if ct_table is None else ct_table.data_ptr(), level_i32.data_ptr(),
        level_f32.data_ptr(), ct_gy.data_ptr(), gtable2.data_ptr(), ct_x.data_ptr(), B,
        plan.d, plan.f, plan.n_levels, INTERP_CODES[plan.interpolation], *plan.c_hash(),
        gy.shape[1], groups, warps, grid,
    )
    return ct_gy, gtable2, ct_x


def _level_columns(plan: GridPlan, gy):
    """The encoding cotangent as K4 reads it: bf16, contiguous, cut to its
    leading L*F columns where its width is not a multiple of F."""
    return _cut_to_levels(plan, gy).to(torch.bfloat16).contiguous()


class GridEncodeFn(torch.autograd.Function):
    """The grid encoding as an autograd Function of its f32 params slice
    (counterpart of ``_grid_pallas`` and its custom vjp, grid_kernel.py:
    1363-1387). The params are cast to the bf16 table inside `forward`, so
    the table gradient comes back in f32. Inputs get no gradient here: the
    input-gradient path is `GridIgFn`. A stochastic plan's backward is K4's
    stochastic option."""

    @staticmethod
    def forward(ctx, params, x, plan, out_width, n_active):
        table = params.reshape(plan.total_rows, plan.f).to(torch.bfloat16).contiguous()
        ctx.save_for_backward(x)
        ctx.plan, ctx.n_active = plan, n_active
        return grid_encode(plan, table, x, out_width, n_active)

    @staticmethod
    def backward(ctx, gy):
        (x,) = ctx.saved_tensors
        g = grid_backward(ctx.plan, x, _level_columns(ctx.plan, gy), ctx.n_active)
        return g.reshape(-1), None, None, None, None


class GridIgFn(torch.autograd.Function):
    """The grid encoding as a function of its f32 params slice AND of x,
    differentiable twice (counterpart of ``_grid_pallas_ig``,
    grid_kernel.py:1238-1255): the forward is K1 over every level, the
    backward is `GridIgBackwardFn`, whose own backward is K8."""

    @staticmethod
    def forward(ctx, params, x, plan, out_width):
        table = params.reshape(plan.total_rows, plan.f).to(torch.bfloat16).contiguous()
        ctx.save_for_backward(params, x)
        ctx.plan = plan
        ctx.set_materialize_grads(False)
        return grid_encode(plan, table, x, out_width, plan.n_levels)

    @staticmethod
    def backward(ctx, gy):
        if gy is None:
            return None, None, None, None
        params, x = ctx.saved_tensors
        gparams, gx = GridIgBackwardFn.apply(params, x, gy, ctx.plan)
        return gparams, gx, None, None


class GridIgBackwardFn(torch.autograd.Function):
    """(gparams f32 [n_params], gx f32 [B, D]) = the encoding's backward at
    (params, x) for the cotangent gy, as a differentiable function
    (counterpart of ``_ig_backward``, grid_kernel.py:1202-1235): the
    forward is K7, the backward K8. A None cotangent of gparams (the
    eikonal loss reads only gx) skips K8's second gather. A third
    derivative raises, as in the JAX package."""

    @staticmethod
    def forward(ctx, params, x, gy, plan):
        table = params.reshape(plan.total_rows, plan.f).to(torch.bfloat16).contiguous()
        gyb = gy.to(torch.bfloat16).contiguous()
        gtable, gx = grid_backward_ig(plan, table, x, gyb)
        ctx.save_for_backward(params, x, gyb)
        ctx.plan = plan
        ctx.set_materialize_grads(False)
        return gtable.reshape(-1), gx

    @staticmethod
    def backward(ctx, ct_gparams, z):
        if ct_gparams is None and z is None:
            return None, None, None, None
        params, x, gyb = ctx.saved_tensors
        plan = ctx.plan
        table = params.reshape(plan.total_rows, plan.f).to(torch.bfloat16).contiguous()
        ct_table = (None if ct_gparams is None else
                    ct_gparams.reshape(plan.total_rows, plan.f).to(torch.bfloat16).contiguous())
        zz = None if z is None else z.float().contiguous()
        ct_gy, gtable2, ct_x = grid_backward_bwd(plan, table, ct_table, x, gyb, zz)
        return no_third_order(gtable2.reshape(-1), ct_x, ct_gy) + (None,)


class _NoThirdOrder(torch.autograd.Function):
    """Identity on the outputs of a second-order backward whose own
    derivative is not implemented: differentiating them raises."""

    @staticmethod
    def forward(ctx, *ts):
        return tuple(t.clone() for t in ts)

    @staticmethod
    def backward(ctx, *cts):
        raise NotImplementedError(
            "third-order derivatives through the input-gradient kernels are not "
            "implemented (the JAX package's Pallas path raises there too)"
        )


def no_third_order(*ts) -> tuple:
    """`ts` as they are, unless autograd is recording (a create_graph
    backward), where a third differentiation of them must raise."""
    live = [t for t in ts if t is not None]
    if not torch.is_grad_enabled() or not any(t.requires_grad for t in live):
        return ts
    wrapped = iter(_NoThirdOrder.apply(*live))
    return tuple(None if t is None else next(wrapped) for t in ts)


def _check_x(plan: GridPlan, x) -> int:
    """Device/dtype/shape checks of the inputs of K1, K3, K4 and K6. Returns B."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != plan.d:
        raise ValueError(f"x must be float32 [B, {plan.d}], got {x.dtype} {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda":
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")
        if plan.total_rows * plan.f >= 2**31:
            raise ValueError("table exceeds the kernels' 2^31-element index range")
    return x.shape[0]


def _check_inputs(plan: GridPlan, table, x) -> int:
    """Shared device/dtype/shape/contiguity checks of K1, K3 and K6. Returns B."""
    _check_x(plan, x)
    if table.dtype != torch.bfloat16 or tuple(table.shape) != (plan.total_rows, plan.f):
        raise ValueError(
            f"table must be bfloat16 [{plan.total_rows}, {plan.f}], "
            f"got {table.dtype} {tuple(table.shape)}"
        )
    if table.device != x.device:
        raise ValueError(f"table on {table.device}, x on {x.device}")
    if x.device.type == "cuda":
        if not table.is_contiguous() or table.data_ptr() % 16:
            raise ValueError("table must be contiguous and 16-byte aligned")
    return x.shape[0]
