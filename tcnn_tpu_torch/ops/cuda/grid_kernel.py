"""Multiresolution grid forward and backward: kernels K1
(``csrc/grid_fwd.cu``) and K4 (``csrc/grid_bwd.cu``), their plain PyTorch
twins, and `GridEncodeFn`, the autograd Function that joins them.

K1 replaces ``tcnn_tpu/ops/pallas/grid_kernel.py:_fwd_kernel`` (reached
through ``_fwd_call`` and ``grid_encode_pallas``), K4 replaces its
``_bwd_kernel`` (through ``_bwd_call`` and ``_grid_pallas_bwd``). The TPU
kernels gather and scatter through one-hot matmuls against a 128-lane packed
table because the TPU has no per-lane random access; on Hopper each thread
owns one (sample, level), reads its 2^D corner rows directly from a bf16
[total_rows, F] table that stays in L2, and scatters the table gradient with
f32 atomics. Only the bf16 rounding carries over from the TPU layout; the
public column order is the JAX package's (level-major, feature-minor).

`grid_encode` and `grid_backward` take the plain twin for a CPU tensor and
the kernel for a CUDA tensor; there is no other route.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...common import GridType, HashType, InterpolationType, smoothstep
from . import _build

#: Launches of K1 and of K4 since the last reset (counted where each
#: kernel launches).
LAUNCHES = 0
BWD_LAUNCHES = 0

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


def hash_factors(hash_type: HashType, n_dims: int) -> tuple:
    if hash_type == HashType.Prime:
        f = _PRIMES
    elif hash_type == HashType.CoherentPrime:
        f = (1,) + _PRIMES[1:]
    elif hash_type == HashType.ReversedPrime:
        f = tuple(reversed(_PRIMES))
    else:
        raise NotImplementedError(
            "HashType.Rng (the PCG32-advance hash) is not ported to "
            "tcnn_tpu_torch yet (ROADMAP Queue A item 8)"
        )
    return tuple(int(v) for v in f[:n_dims])


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


def index_within_level(cells, strides, use_hash, factors, sizes):
    """Per-level table row of integer grid cells (grid_index,
    common_device.h:690-707), in int64 holding uint32 values.

    cells: int64 [..., L, C, D] uint32 cells; strides: int64 [L, D];
    use_hash: bool [L]; factors: D python ints (None when no level hashes);
    sizes: int64 [L]. Returns int64 [..., L, C] in [0, size)."""
    d = cells.shape[-1]
    strides = strides[:, None, :]  # [L, 1, D] broadcast over corners
    dense = torch.zeros(cells.shape[:-1], dtype=torch.int64, device=cells.device)
    for dim in range(d):
        dense = (dense + mul_u32(cells[..., dim], strides[..., dim])) & U32
    raw = dense
    if factors is not None:
        hashed = torch.zeros_like(dense)
        for dim in range(d):
            hashed = hashed ^ mul_u32(cells[..., dim], factors[dim])
        raw = torch.where(use_hash[:, None], hashed, dense)
    return raw % sizes[:, None]


def positions(x, scales, interpolation: InterpolationType):
    """pos_fract (common_device.h:826-867): x [..., D] f32 and per-level
    scales [..., L] -> (int64 uint32 cells, f32 weights) [..., L, D], with
    pos = x * scale + 0.5 rounded after the multiply and after the add, the
    cell int32(floor(pos)) reinterpreted as uint32, and the weight the
    fraction (or its smoothstep)."""
    pos = x[..., None, :] * scales[..., :, None] + 0.5
    cell_f = torch.floor(pos)
    fract = pos - cell_f
    cells = cell_f.to(torch.int32).to(torch.int64) & U32
    w = smoothstep(fract) if interpolation == InterpolationType.Smoothstep else fract
    return cells, w


class GridPlan:
    """Everything K1 and K3 need to know of a GridEncoding: per-level
    offset, size, scale, hash flag and uint32 strides, the hash factors,
    the interpolation. Built once per encoding and passed explicitly to every
    call; the per-level constants go to each device once, as
    `level_i32` [L, 8] (offset, size, use_hash, stride 0..3, 0) and
    `level_f32` [L] (scale)."""

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
        self.hash_factors = (
            hash_factors(enc.hash_type, self.d) if any(use_hash) else None
        )
        self._device_consts = {}

    @property
    def n_corners(self) -> int:
        if self.interpolation == InterpolationType.Nearest:
            return 1
        return 1 << self.d

    def c_factors(self) -> tuple:
        """The four hash-factor arguments of the C entry points."""
        return tuple(self.hash_factors or (0,) * self.d) + (0,) * (4 - self.d)

    def device_consts(self, device):
        """(level_i32 [L, 8] int32, level_f32 [L] f32) on `device`."""
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


def _corners(plan: GridPlan, x):
    """Yields, for each corner c = 0..C-1, the absolute table rows
    [B, L] int64 of every (sample, level) and the corner weights [B, L] f32
    (the product over dims d = 0..D-1 of w_d or 1 - w_d; 1 for Nearest):
    the f32 position, cell and weight math of K1/K4 with one rounding per
    operation."""
    L, D = plan.n_levels, plan.d
    dev = x.device
    scales = torch.from_numpy(plan.scales).to(dev)
    cells, w = positions(x, scales, plan.interpolation)  # [B, L, D]
    strides = torch.tensor(plan.strides, dtype=torch.int64, device=dev).reshape(L, D)
    use_hash = torch.tensor(plan.use_hash, dtype=torch.bool, device=dev)
    sizes = torch.tensor(plan.sizes, dtype=torch.int64, device=dev)
    offsets = torch.tensor(plan.offsets, dtype=torch.int64, device=dev)
    nearest = plan.interpolation == InterpolationType.Nearest
    for corner in range(plan.n_corners):
        bits = [(corner >> d) & 1 for d in range(D)]
        cc = (cells + torch.tensor(bits, dtype=torch.int64, device=dev)) & U32
        idx = index_within_level(
            cc[:, :, None, :], strides, use_hash, plan.hash_factors, sizes
        )[..., 0]
        cw = torch.ones_like(w[..., 0])
        if not nearest:
            cw = None
            for d in range(D):
                term = w[..., d] if bits[d] else 1.0 - w[..., d]
                cw = term if cw is None else cw * term
        yield offsets[None, :] + idx, cw


def _grid_encode_plain(plan: GridPlan, table, x, out_width: int, n_active: int):
    """What K1 computes, in plain PyTorch on any device: bf16 table rows
    weighted and summed over corners c = 0..C-1 in f32, one rounding to
    bf16, zeros in levels >= n_active and in the padding columns."""
    B = x.shape[0]
    L, F = plan.n_levels, plan.f
    acc = torch.zeros((B, L, F), dtype=torch.float32, device=x.device)
    for rows, cw in _corners(plan, x):
        acc = acc + table[rows].float() * cw[..., None]
    acc[:, n_active:] = 0.0
    y = torch.zeros((B, out_width), dtype=torch.bfloat16, device=x.device)
    y[:, : L * F] = acc.reshape(B, L * F).to(torch.bfloat16)
    return y


def _grid_backward_plain(plan: GridPlan, x, gy, n_active: int):
    """What K4 computes, in plain PyTorch on any device: the table gradient
    f32 [total_rows, F] of the encoding's leading L*F columns of `gy`, each
    corner's contribution w_c * gy rounded to bf16 before it is summed in
    f32, as the TPU kernel rounds it (grid_kernel.py:674-677); levels
    >= n_active contribute nothing."""
    B = x.shape[0]
    L, F = plan.n_levels, plan.f
    g = gy[:, : L * F].float().reshape(B, L, F)[:, :n_active]
    out = torch.zeros((plan.total_rows, F), dtype=torch.float32, device=x.device)
    for rows, cw in _corners(plan, x):
        contrib = (cw[:, :n_active, None] * g).to(torch.bfloat16).float()
        out.index_add_(0, rows[:, :n_active].reshape(-1), contrib.reshape(-1, F))
    return out


def grid_encode(plan: GridPlan, table, x, out_width: int, n_active: int):
    """x [B, D] f32 -> [B, out_width] bf16: levels in columns
    [0, L*F), levels >= n_active zeroed, columns [L*F, out_width) zero.
    `table` is the bf16 [total_rows, F] feature table."""
    B = _check_inputs(plan, table, x)
    if out_width < plan.n_levels * plan.f:
        raise ValueError(f"out_width {out_width} < L*F = {plan.n_levels * plan.f}")
    if x.device.type == "cpu":
        return _grid_encode_plain(plan, table, x, out_width, n_active)
    global LAUNCHES
    out = torch.empty((B, out_width), dtype=torch.bfloat16, device=x.device)
    if B == 0:
        return out
    level_i32, level_f32 = plan.device_consts(x.device)
    fn = _build.function("tcnn_grid_fwd", _GRID_FWD_ARGS)
    _build.check(
        fn(
            x.data_ptr(), table.data_ptr(), level_i32.data_ptr(),
            level_f32.data_ptr(), out.data_ptr(), B, plan.d, plan.f,
            plan.n_levels, int(n_active), INTERP_CODES[plan.interpolation],
            *plan.c_factors(), out_width, x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream,
        ),
        "tcnn_grid_fwd",
    )
    LAUNCHES += 1
    return out


_GRID_FWD_ARGS = (
    [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 6
    + [ctypes.c_uint32] * 4
    + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)


def grid_backward(plan: GridPlan, x, gy, n_active: int):
    """Table gradient f32 [total_rows, F] of the encoding at `x` [B, D] f32
    for the cotangent `gy` [B, >= L*F] (bf16 on a CUDA tensor; its leading
    L*F columns, level-major, are read)."""
    B = _check_x(plan, x)
    if gy.dim() != 2 or gy.shape[0] != B or gy.shape[1] < plan.n_levels * plan.f:
        raise ValueError(f"gy must be [{B}, >= {plan.n_levels * plan.f}], got {tuple(gy.shape)}")
    if gy.device != x.device:
        raise ValueError(f"gy on {gy.device}, x on {x.device}")
    if x.device.type == "cpu":
        return _grid_backward_plain(plan, x, gy, n_active)
    if gy.dtype != torch.bfloat16 or not gy.is_contiguous() or gy.data_ptr() % 16:
        raise ValueError(f"gy must be contiguous, 16-byte aligned bfloat16, got {gy.dtype}")
    if gy.shape[1] % plan.f:
        raise ValueError(f"gy's width {gy.shape[1]} must be a multiple of F = {plan.f}")
    global BWD_LAUNCHES
    out = torch.zeros((plan.total_rows, plan.f), dtype=torch.float32, device=x.device)
    if B == 0 or n_active == 0:
        return out
    level_i32, level_f32 = plan.device_consts(x.device)
    fn = _build.function("tcnn_grid_bwd", _GRID_BWD_ARGS)
    _build.check(
        fn(
            x.data_ptr(), gy.data_ptr(), level_i32.data_ptr(), level_f32.data_ptr(),
            out.data_ptr(), B, plan.d, plan.f, plan.n_levels, int(n_active),
            INTERP_CODES[plan.interpolation], *plan.c_factors(), gy.shape[1],
            x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
        ),
        "tcnn_grid_bwd",
    )
    BWD_LAUNCHES += 1
    return out


_GRID_BWD_ARGS = _GRID_FWD_ARGS


class GridEncodeFn(torch.autograd.Function):
    """The grid encoding as an autograd Function of its f32 params slice
    (counterpart of ``_grid_pallas`` and its custom vjp, grid_kernel.py:
    1363-1387). The params are cast to the bf16 table inside `forward`, so
    the table gradient comes back in f32. Inputs get no gradient here: the
    input-gradient path is ROADMAP Queue A item 7."""

    @staticmethod
    def forward(ctx, params, x, plan, out_width, n_active, stochastic):
        table = params.reshape(plan.total_rows, plan.f).to(torch.bfloat16).contiguous()
        ctx.save_for_backward(x)
        ctx.plan, ctx.n_active, ctx.stochastic = plan, n_active, stochastic
        return grid_encode(plan, table, x, out_width, n_active)

    @staticmethod
    def backward(ctx, gy):
        if ctx.stochastic:
            raise NotImplementedError(
                "the stochastic-interpolation table gradient is not ported to "
                "tcnn_tpu_torch yet (ROADMAP Queue A item 8)"
            )
        (x,) = ctx.saved_tensors
        g = grid_backward(ctx.plan, x, gy.to(torch.bfloat16).contiguous(), ctx.n_active)
        return g.reshape(-1), None, None, None, None, None


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
