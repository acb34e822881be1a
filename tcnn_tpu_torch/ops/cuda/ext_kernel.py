"""Externally indexed table lookups of the PPNG encodings: kernels K10
``ext_gather`` and K12 ``ext_lookup`` (``csrc/ext_gather.cu``), K11
``ext_scatter`` and K13 ``ext_lookup_bwd`` (``csrc/ext_scatter.cu``), their
plain PyTorch twins, and the autograd Functions that join them.

Every table here is flat [n_rows, F], its levels (one small table per
frequency, phase and axis or plane) at their own row offsets, and the caller
hands each pick its global row as int32: idx [B, C * NL], column c * NL + l
for corner c of level l, the layout of ``tcnn_tpu``'s dense-ext and binned
kernels (which carry level-local rows as f32).

  - K10 replaces ``dense_ext_kernel.py:_gather_kernel`` (``dense_ext_gather``):
    raw picks [B, C * NL * F] in the table's own dtype (bf16 for PPNG2, f32
    for PPNG1, whose JAX einsum reads the f32 params).
  - K11 replaces ``dense_ext_kernel.py:_scatter_kernel`` (``dense_ext_scatter``):
    its transpose into an f32 gradient table, the cotangents read in their
    own dtype: `ExtScatterFn` hands them over in the gathered table's, so
    they are rounded to bf16 exactly where the forward read bf16.
    `scatter_plan` chooses the levels it sums in shared memory.
  - K12 replaces the ext_iw forward of ``binned_kernel.py``
    (``binned_ext_lookup``) and PPNG3's dense-ext gather plus weighted sum:
    y [B, NL * F] bf16 = sum over corners c of cw * T[idx], in f32.
    `lookup_threads` sizes its blocks.
  - K13 replaces ``binned_kernel.py:_combine_extg_kernel`` with the ext_iw
    place/scatter: dT += bf16(cw * gy) and dcw = sum_f T[idx] * gy, its
    levels in blocks of `lookup_chunk`.

Each wrapper takes the plain twin for a CPU tensor and the kernel for a CUDA
tensor; there is no other route. The twins also run in float64 (no
rounding, for gradcheck), which the kernels never do.

`ExtGatherFn` and `ExtScatterFn` are each other's backward, and the lookup
y(T, cw) is trilinear in (T, cw, gy), so `ExtLookupFn`,
`ExtLookupScatterFn` and `ExtLookupDotsFn` close under differentiation:
gradients compose to any order (dense_ext_kernel.py:25-32,
binned_kernel.py:1833-1862).
"""

from __future__ import annotations

import dataclasses

import torch

from . import _build
from .mlp_kernel import SMEM_OPTIN
from .train_kernel import SMEM_SM

#: Row widths K12 and K13 take (PPNG3's n_features).
LOOKUP_WIDTHS = (1, 2, 4, 8)
#: Threads of a K12 block at most (csrc/ext_gather.cu: __launch_bounds__).
LOOKUP_THREADS = 256
#: Columns (corners x levels) and cotangents a sample of a K13 block's
#: staged chunk (csrc/ext_scatter.cu:kTileCols); so also the most corners a
#: level K13 takes.
LOOKUP_TILE_COLS = 64

#: Warps an H100 SM holds at once.
SM_WARPS = 64
#: Shared memory a K11 block may sum its private levels' f32 gradient in:
#: all that one block can have, one block an SM (PPNG1's 36 tables,
#: 147,456 bytes, in one group of 18 warps). Chosen by
#: scripts/time_ext_kernels.py --budgets (H100 80GB HBM3, 700 W; PPNG1,
#: B = 2^16): 0.198 ms, against 0.258 at 115,712 bytes (two groups of 18
#: tables, three blocks an SM) and 0.221 at 34,816 (five groups of 8, six
#: blocks an SM).
K11_PRIVATE_BYTES = SMEM_OPTIN
#: Fewest adds a private float must take from each block's share of the
#: picks (on average over its rows) for the copy's zeroing and flush to
#: pay: where the batch cannot give that to every resident block, the
#: levels take the global route.
K11_MIN_ADDS = 8


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """Where K11 sums each level's gradient: levels 0..n_private-1 in a
    block's shared memory, `group_levels` consecutive levels a group (the
    last group may hold fewer), each group's samples split over `blocks`
    blocks of `warps` warps, each warp the only one to add into its
    ceil(group_levels / warps) levels; levels n_private.. by vector atomics
    into the global gradient."""

    n_private: int = 0
    group_levels: int = 0
    warps: int = 0
    blocks: int = 0

    def groups(self) -> list:
        """[(first level, end level)] of each private group."""
        g = self.group_levels
        return [(l0, min(l0 + g, self.n_private)) for l0 in range(0, self.n_private, g or 1)]


def scatter_plan(n_levels: int, rows_per_level: int, f: int, corners: int, batch: int,
                 n_sm: int, budget: int = None) -> ScatterPlan:
    """K11's plan for tables of `n_levels` levels of `rows_per_level` rows x
    `f` features, `corners` picks a level and sample, `batch` samples, on a
    card of `n_sm` SMs: every level private, in as few groups of
    consecutive levels as fit `budget` bytes (default K11_PRIVATE_BYTES) of
    f32 gradient each, balanced, when a level fits and the batch gives
    each resident block of a group (the resident blocks shared among the
    groups) K11_MIN_ADDS adds a private float; else every level global. A
    warp a level, or as few levels a warp as keep a block within 32
    warps."""
    budget = min(K11_PRIVATE_BYTES if budget is None else budget, SMEM_OPTIN)
    level_bytes = rows_per_level * f * 4
    fit = budget // level_bytes
    if fit == 0:
        return ScatterPlan()
    n_groups = -(-n_levels // fit)
    g = -(-n_levels // n_groups)
    per_warp = -(-g // 32)
    warps = -(-g // per_warp)
    per_sm = min(SMEM_SM // (g * level_bytes + 1024), SM_WARPS // warps)
    blocks = n_sm * per_sm // n_groups
    if blocks == 0 or batch * corners < K11_MIN_ADDS * rows_per_level * blocks:
        return ScatterPlan()
    return ScatterPlan(n_levels, g, warps, blocks)


def lookup_threads(n_lanes: int, n_sm: int) -> int:
    """K12's block size for `n_lanes` lanes, a lane a (sample, level), on a
    card of `n_sm` SMs: LOOKUP_THREADS, halved down to 64 while the lanes
    leave fewer blocks than SMs (the eikonal term's 1024 points at PPNG3's
    sample config: 128 blocks of 64). Chosen by
    scripts/time_ext_kernels.py --plans (H100 80GB HBM3, 700 W; PERF.md
    §6)."""
    threads = LOOKUP_THREADS
    while threads > 64 and -(-n_lanes // threads) < n_sm:
        threads //= 2
    return threads


@dataclasses.dataclass(frozen=True)
class ExtSpec:
    """The tables of a lookup: rows (all levels), features per row, levels
    per sample (K12/K13), and the dtype the kernels read them in (bf16, or
    f32 for PPNG1; float64 runs the twins without rounding), which is also
    the dtype of the picks' cotangents that K11 scatters."""

    n_rows: int
    f: int
    dtype: torch.dtype
    n_levels: int = 1

    def table(self, params):
        """The flat f32 params as the [n_rows, F] table the kernels read."""
        return params.reshape(self.n_rows, self.f).to(self.dtype).contiguous()


def _acc(dtype) -> torch.dtype:
    """The twins' accumulation type: f32, or f64 for f64 inputs."""
    return torch.float64 if dtype == torch.float64 else torch.float32


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def _ext_gather_plain(table, idx):
    """What K10 computes: picks [B, K * F] = table rows idx [B, K], in the
    table's dtype."""
    return table[idx.long()].reshape(idx.shape[0], -1)


def _ext_scatter_plain(idx, ct, n_rows: int):
    """What K11 computes: f32 [n_rows, F] (f64 for f64 ct) with
    ct [B, K * F] added at rows idx [B, K]."""
    B, K = idx.shape
    acc = _acc(ct.dtype)
    c = ct.reshape(B * K, -1)
    out = torch.zeros((n_rows, c.shape[1]), dtype=acc, device=ct.device)
    out.index_add_(0, idx.reshape(-1).long(), c.to(acc))
    return out


def _ext_lookup_plain(table, idx, cw, n_levels: int):
    """What K12 computes: y [B, NL * F] = sum over corners c = 0..C-1 of
    cw[:, c*NL + l] * table[idx[:, c*NL + l]] in f32 (f64 for f64 cw), in
    corner order, returned in the table's dtype."""
    B = idx.shape[0]
    C = idx.shape[1] // n_levels
    acc = _acc(cw.dtype)
    picks = table[idx.long()].to(acc).reshape(B, C, n_levels, -1)
    w = cw.to(acc).reshape(B, C, n_levels, 1)
    y = torch.zeros_like(picks[:, 0])
    for c in range(C):
        y = y + w[:, c] * picks[:, c]
    return y.reshape(B, -1).to(table.dtype)


def _fsum(terms):
    """Left-to-right sum (the kernels' order)."""
    out = None
    for t in terms:
        out = t if out is None else out + t
    return out


def _ext_lookup_bwd_plain(table, idx, cw, gy, n_rows: int, n_levels: int, want_table: bool,
                          want_dots: bool):
    """What K13 computes for the cotangent gy [B, NL * F] of K12: (dT f32
    [n_rows, F] with bf16(cw * gy) added at each pick's row, or None;
    dcw f32 [B, C * NL] = sum_f table[idx, f] * gy[f] in f order, or None).
    With f64 gy, both in f64 and nothing rounded."""
    B, CNL = idx.shape
    C = CNL // n_levels
    acc = _acc(gy.dtype)
    g = gy.to(acc).reshape(B, 1, n_levels, -1)
    dT = dcw = None
    if want_table:
        contrib = cw.to(acc).reshape(B, C, n_levels, 1) * g
        if acc == torch.float32:
            contrib = contrib.to(torch.bfloat16).float()
        dT = torch.zeros((n_rows, g.shape[-1]), dtype=acc, device=gy.device)
        dT.index_add_(0, idx.reshape(-1).long(), contrib.reshape(B * CNL, -1))
    if want_dots:
        t = table[idx.long()].to(acc).reshape(B, C, n_levels, -1)
        dcw = _fsum(t[..., f] * g[..., f] for f in range(g.shape[-1])).reshape(B, CNL)
    return dT, dcw


# ---------------------------------------------------------------------------
# Wrappers: the twin for a CPU tensor, the kernel for a CUDA tensor
# ---------------------------------------------------------------------------


def _check_idx(idx):
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError(f"idx must be int32 [B, K], got {idx.dtype} {tuple(idx.shape)}")
    if idx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {idx.device}")
    if idx.device.type == "cuda":
        if not idx.is_contiguous():
            raise ValueError("idx must be contiguous")
        if idx.numel() >= 2**31:
            raise ValueError("more picks than the kernels' int32 range")


def _check_cuda(name, t, device, dtype=None):
    """A kernel operand: on `device`, contiguous, 16-byte aligned."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, idx on {device}")
    if device.type == "cuda":
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def ext_gather(table, idx):
    """picks [B, K * F] = the rows idx [B, K] (int32, global) of `table`
    [n_rows, F], f32 or bf16, returned in the table's dtype (K10)."""
    _check_idx(idx)
    _check_cuda("table", table, idx.device)
    if table.dim() != 2:
        raise ValueError(f"table must be [n_rows, F], got {tuple(table.shape)}")
    if idx.device.type == "cpu":
        return _ext_gather_plain(table, idx)
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K10 reads f32 or bf16 tables, got {table.dtype}")
    B, K = idx.shape
    F = table.shape[1]
    out = torch.empty((B, K * F), dtype=table.dtype, device=idx.device)
    if out.numel() == 0:
        return out
    _build.launch("tcnn_ext_gather", idx.device, table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                  B, K, F * table.element_size())
    return out


def ext_scatter(idx, ct, n_rows: int, n_levels: int = 1):
    """The transpose of `ext_gather`: f32 [n_rows, F] with the per-pick
    cotangents ct [B, K * F] (f32 or bf16) added at rows idx [B, K] (K11).
    The rows are `n_levels` equal levels, column j's picks in level
    j % n_levels; `scatter_plan` chooses the levels K11 sums in shared
    memory."""
    _check_idx(idx)
    _check_cuda("ct", ct, idx.device)
    B, K = idx.shape
    if ct.dim() != 2 or ct.shape[0] != B or (K and ct.shape[1] % K):
        raise ValueError(f"ct must be [{B}, K * F] for K = {K}, got {tuple(ct.shape)}")
    if idx.device.type == "cpu":
        return _ext_scatter_plain(idx, ct, n_rows)
    if ct.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K11 reads f32 or bf16 cotangents, got {ct.dtype}")
    if n_levels <= 0 or K % n_levels or n_rows % n_levels:
        raise ValueError(f"{K} columns and {n_rows} rows must be multiples of {n_levels} levels")
    dev = idx.device
    F = ct.shape[1] // K if K else 1
    out = torch.zeros((n_rows, F), dtype=torch.float32, device=dev)
    if idx.numel() == 0:
        return out
    rows = n_rows // n_levels
    plan = scatter_plan(n_levels, rows, F, K // n_levels, B,
                        torch.cuda.get_device_properties(dev).multi_processor_count)
    _build.launch("tcnn_ext_scatter", dev, idx.data_ptr(), ct.data_ptr(), out.data_ptr(), B, K, F,
                  int(ct.dtype == torch.bfloat16), n_levels, rows, plan.n_private,
                  plan.group_levels, plan.warps, plan.blocks)
    return out


def _check_lookup(idx, n_levels: int, F: int):
    if n_levels <= 0 or idx.shape[1] % n_levels:
        raise ValueError(f"idx width {idx.shape[1]} is not a multiple of NL = {n_levels}")
    if idx.device.type == "cuda":
        if F not in LOOKUP_WIDTHS:
            raise ValueError(f"K12/K13 take rows of {LOOKUP_WIDTHS} features, got {F}")
        if idx.shape[1] // n_levels > LOOKUP_TILE_COLS:
            raise ValueError(f"K12/K13 take at most {LOOKUP_TILE_COLS} corners a level")


def ext_lookup(table, idx, cw, n_levels: int):
    """y [B, NL * F] bf16 = sum over corners c of cw[:, c*NL + l] *
    table[idx[:, c*NL + l]] in f32, corners in order (K12). `table` is the
    bf16 [n_rows, F] table, `cw` f32 [B, C * NL]."""
    _check_idx(idx)
    _check_cuda("table", table, idx.device, torch.bfloat16)
    _check_cuda("cw", cw, idx.device, torch.float32)
    if cw.shape != idx.shape:
        raise ValueError(f"cw {tuple(cw.shape)} and idx {tuple(idx.shape)} differ")
    F = table.shape[1]
    _check_lookup(idx, n_levels, F)
    if idx.device.type == "cpu":
        return _ext_lookup_plain(table, idx, cw, n_levels)
    dev = idx.device
    B, CNL = idx.shape
    y = torch.empty((B, n_levels * F), dtype=torch.bfloat16, device=dev)
    if B == 0:
        return y
    threads = lookup_threads(B * n_levels,
                             torch.cuda.get_device_properties(dev).multi_processor_count)
    _build.launch("tcnn_ext_lookup", dev, table.data_ptr(), idx.data_ptr(), cw.data_ptr(),
                  y.data_ptr(), B, n_levels, CNL // n_levels, F, threads)
    return y


def lookup_chunk(n_levels: int, corners: int, f: int, batch: int, n_sm: int) -> int:
    """K13's plan: the levels a block stages and takes, as many as keep the
    chunk's corners x levels and a sample's cotangents within
    LOOKUP_TILE_COLS (8 at PPNG3's sample config and defaults), and no more
    than leave two blocks an SM where the batch's 32-sample tiles are
    fewer (the eikonal term's 1024 points: a level a block)."""
    most = max(1, min(n_levels, LOOKUP_TILE_COLS // corners, LOOKUP_TILE_COLS // f))
    chunks = -(-2 * n_sm // -(-batch // 32))
    return max(1, min(most, -(-n_levels // chunks)))


def ext_lookup_bwd(table, idx, cw, gy, n_rows: int, n_levels: int, want_table: bool = True,
                   want_dots: bool = True):
    """The backward of `ext_lookup` for its cotangent gy [B, NL * F] f32
    (K13): (dT f32 [n_rows, F], bf16(cw * gy) added at each pick's row, or
    None without `want_table`; dcw f32 [B, C * NL], each pick's bf16 table
    row dotted with gy, or None without `want_dots`). `table` is read only
    for the dots and `cw` only for dT; either may then be None."""
    _check_idx(idx)
    B, CNL = idx.shape
    _check_cuda("gy", gy, idx.device, torch.float32)
    if gy.dim() != 2 or gy.shape[0] != B or gy.shape[1] % n_levels:
        raise ValueError(f"gy must be [{B}, NL * F], got {tuple(gy.shape)}")
    F = gy.shape[1] // n_levels
    _check_lookup(idx, n_levels, F)
    if want_table:
        _check_cuda("cw", cw, idx.device, torch.float32)
        if cw.shape != idx.shape:
            raise ValueError(f"cw {tuple(cw.shape)} and idx {tuple(idx.shape)} differ")
    if want_dots:
        _check_cuda("table", table, idx.device, torch.bfloat16)
        if table.shape != (n_rows, F):
            raise ValueError(f"table must be [{n_rows}, {F}], got {tuple(table.shape)}")
    if idx.device.type == "cpu":
        return _ext_lookup_bwd_plain(table, idx, cw, gy, n_rows, n_levels, want_table, want_dots)
    dev = idx.device
    dT = torch.zeros((n_rows, F), dtype=torch.float32, device=dev) if want_table else None
    dcw = torch.empty((B, CNL), dtype=torch.float32, device=dev) if want_dots else None
    if B == 0 or not (want_table or want_dots):
        return dT, dcw
    _build.launch("tcnn_ext_lookup_bwd", dev, table.data_ptr() if want_dots else None,
                  idx.data_ptr(), cw.data_ptr() if want_table else None, gy.data_ptr(),
                  dT.data_ptr() if want_table else None, dcw.data_ptr() if want_dots else None,
                  B, n_levels, CNL // n_levels, F,
                  lookup_chunk(n_levels, CNL // n_levels, F, B,
                               torch.cuda.get_device_properties(dev).multi_processor_count))
    return dT, dcw


# ---------------------------------------------------------------------------
# Autograd Functions
# ---------------------------------------------------------------------------


class ExtGatherFn(torch.autograd.Function):
    """picks [B, K * F] = rows idx of the table, as a function of the flat
    f32 params (cast to `spec.dtype` inside, so their gradient comes back
    in f32): K10 forward, `ExtScatterFn` backward (dense_ext_gather)."""

    @staticmethod
    def forward(ctx, params, idx, spec: ExtSpec):
        ctx.save_for_backward(idx)
        ctx.spec = spec
        ctx.set_materialize_grads(False)
        return ext_gather(spec.table(params), idx)

    @staticmethod
    def backward(ctx, ct):
        if ct is None:
            return None, None, None
        (idx,) = ctx.saved_tensors
        return ExtScatterFn.apply(ct, idx, ctx.spec), None, None


class ExtScatterFn(torch.autograd.Function):
    """The flat table gradient of per-pick cotangents ct [B, K * F], cast
    to the table's dtype (the rounding of dense_ext_kernel.py:161 where
    that is bf16): K11 forward, `ExtGatherFn` backward (dense_ext_scatter)."""

    @staticmethod
    def forward(ctx, ct, idx, spec: ExtSpec):
        ctx.save_for_backward(idx)
        ctx.spec = spec
        ctx.set_materialize_grads(False)
        return ext_scatter(idx, ct.to(spec.dtype).contiguous(), spec.n_rows,
                           spec.n_levels).reshape(-1)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None
        (idx,) = ctx.saved_tensors
        return ExtGatherFn.apply(g, idx, ctx.spec), None, None


class ExtLookupFn(torch.autograd.Function):
    """y [B, NL * F] = sum_c cw * T[idx] as a function of the flat f32
    params (read as a bf16 table) and the weights cw [B, C * NL]: K12
    forward; backward `ExtLookupScatterFn` for the params and
    `ExtLookupDotsFn` for cw, or one K13 launch for both when no graph of
    the backward is built."""

    @staticmethod
    def forward(ctx, params, cw, idx, spec: ExtSpec):
        ctx.save_for_backward(params, cw, idx)
        ctx.spec = spec
        ctx.set_materialize_grads(False)
        return ext_lookup(spec.table(params), idx, cw.contiguous(), spec.n_levels)

    @staticmethod
    def backward(ctx, gy):
        if gy is None:
            return None, None, None, None
        params, cw, idx = ctx.saved_tensors
        spec = ctx.spec
        need_t, need_cw = ctx.needs_input_grad[:2]
        g = gy.to(_acc(spec.dtype))
        if torch.is_grad_enabled():
            dT = ExtLookupScatterFn.apply(cw, g, idx, spec) if need_t else None
            dcw = ExtLookupDotsFn.apply(params, g, idx, spec) if need_cw else None
            return dT, dcw, None, None
        dT, dcw = ext_lookup_bwd(spec.table(params) if need_cw else None, idx,
                                 cw.contiguous() if need_t else None, g.contiguous(),
                                 spec.n_rows, spec.n_levels, need_t, need_cw)
        return None if dT is None else dT.reshape(-1), dcw, None, None


class ExtLookupScatterFn(torch.autograd.Function):
    """dT (flat, f32) = the scatter of bf16(cw * gy) at each pick's row:
    K13 with its table half only; backward `ExtLookupDotsFn` for cw and
    `ExtLookupFn` for gy."""

    @staticmethod
    def forward(ctx, cw, gy, idx, spec: ExtSpec):
        ctx.save_for_backward(cw, gy, idx)
        ctx.spec = spec
        ctx.set_materialize_grads(False)
        dT, _ = ext_lookup_bwd(None, idx, cw.contiguous(), gy.contiguous(), spec.n_rows,
                               spec.n_levels, want_table=True, want_dots=False)
        return dT.reshape(-1)

    @staticmethod
    def backward(ctx, ct):
        if ct is None:
            return None, None, None, None
        cw, gy, idx = ctx.saved_tensors
        spec = ctx.spec
        dcw = ExtLookupDotsFn.apply(ct, gy, idx, spec) if ctx.needs_input_grad[0] else None
        dgy = ExtLookupFn.apply(ct, cw, idx, spec) if ctx.needs_input_grad[1] else None
        return dcw, dgy, None, None


class ExtLookupDotsFn(torch.autograd.Function):
    """dcw [B, C * NL] = each pick's table row (flat f32 params read as
    bf16) dotted with gy: K13 with its dots half only; backward
    `ExtLookupScatterFn` for the params and `ExtLookupFn` for gy."""

    @staticmethod
    def forward(ctx, params, gy, idx, spec: ExtSpec):
        ctx.save_for_backward(params, gy, idx)
        ctx.spec = spec
        ctx.set_materialize_grads(False)
        _, dcw = ext_lookup_bwd(spec.table(params), idx, None, gy.contiguous(), spec.n_rows,
                                spec.n_levels, want_table=False, want_dots=True)
        return dcw

    @staticmethod
    def backward(ctx, ct):
        if ct is None:
            return None, None, None, None
        params, gy, idx = ctx.saved_tensors
        spec = ctx.spec
        dT = ExtLookupScatterFn.apply(ct, gy, idx, spec) if ctx.needs_input_grad[0] else None
        dgy = ExtLookupFn.apply(params, ct, idx, spec) if ctx.needs_input_grad[1] else None
        return dT, dgy, None, None
