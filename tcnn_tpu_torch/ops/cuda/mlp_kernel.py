"""Fully fused MLP forward and backward: kernels K2 (``csrc/mlp_fwd.cu``)
and K5 (``csrc/mlp_bwd.cu``), their plain PyTorch twins, and `FusedMlpFn`,
the autograd Function that joins them.

K2 replaces ``tcnn_tpu/ops/pallas/mlp_kernel.py:_fwd_kernel`` (reached
through ``_fwd_call`` and ``fused_mlp_apply``), K5 its ``_bwd_kernel``
(through ``_bwd_call`` and ``_fused_mlp_bwd``). All layer weights sit in
shared memory, padded to a row pitch of fan_in + 8 (`frag_weight_elems`);
the products run on the tensor cores (``mma.sync``, ``csrc/mlp_frag.cuh``)
in bf16 with f32 accumulation, with the activations in registers between
layers, and each layer's activation is applied in f32 and rounded to bf16,
as ``mlp_kernel.py:51-62`` does. Sine has no fused form
(``mlp_kernel.py:44-48``); FullyFusedMLP sends it to the matmul chain.

K2 is K3's chain without the gather: persistent blocks load the weights
once, and each warp copies its 16 input rows into its own slice of shared
memory and runs them through every layer (`frag_tile_smem_bytes`,
`frag_tile_warps`). K5 recomputes the forward chain keeping every layer's
bf16 output, then runs the dgrad chain as ``mlp_kernel.py:86-106`` does:
g = act'(g) from the kept output, rounded to bf16, gW += h^T g in f32,
g = g W; the input gradient leaves as bf16. Weight gradients come out in the
params slice's own flat row-major [fan_out, fan_in] layout, with no
transpose. K5 keeps the weight gradient in registers across tiles;
`mlp_bwd_smem_bytes` and `mlp_bwd_tile` mirror its layout and tile on the
CPU. Where that resident plan cannot give a block 4 warps (width 128 with
many layers: its padded weights fill the block's shared memory),
`mlp_bwd_plan` sends K5 to its split plan (``csrc/mlp_bwd_split.cu``): a
dgrad kernel on K2's plan that writes the kept outputs and every layer's
bf16 G to scratch, then a split-K weight-gradient kernel over row slices
whose partials the same fixed-order reduction sums (`mlp_dgrad_warps`,
`mlp_dgrad_smem_bytes`, `mlp_wgrad_smem_bytes`, `mlp_bwd_split_scratch`
mirror it).

`mlp_forward` and `mlp_backward` take the plain twin for a CPU tensor and
the kernel for a CUDA tensor; there is no other route.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ...common import Activation
from ...utils import profiling
from ..activations import ACTIVATION_CODES, activation_bwd_out, activation_fn
from . import _build

FUSED_WIDTHS = (16, 32, 64, 128)

#: Shared memory a block may opt in to on Hopper (232,448 bytes); the
#: backward kernels' tile is chosen against it before launch.
SMEM_OPTIN = 232_448


@dataclasses.dataclass(frozen=True)
class MlpDims:
    """The shape of a fully fused MLP: input width, hidden width, hidden
    layer count, padded output width and the two activations."""

    in_w: int
    width: int
    n_hidden: int
    out_w: int
    activation: Activation
    output_activation: Activation

    def layer_sizes(self):
        """[(fan_out, fan_in)] of every weight matrix (mlp.py:57-64)."""
        w = self.width
        return [(w, self.in_w)] + [(w, w)] * (self.n_hidden - 1) + [(self.out_w, w)]

    @property
    def n_weights(self) -> int:
        return sum(r * c for r, c in self.layer_sizes())

    def check_fused(self) -> None:
        """Raise unless the CUDA kernels take this shape."""
        if self.width not in FUSED_WIDTHS:
            raise ValueError(f"fused MLP width {self.width} not in {FUSED_WIDTHS}")
        if self.n_hidden < 1:
            raise ValueError("fused MLP needs at least one hidden layer")
        if self.in_w % 16 or self.out_w % 16:
            raise ValueError(
                f"fused MLP input ({self.in_w}) and output ({self.out_w}) widths "
                "must be multiples of 16"
            )
        if Activation.Sine in (self.activation, self.output_activation):
            raise ValueError("the fused MLP kernels do not run Sine")

    def c_args(self):
        return (
            self.in_w, self.width, self.n_hidden, self.out_w,
            ACTIVATION_CODES[self.activation],
            ACTIVATION_CODES[self.output_activation],
        )


def tile_rows(dims: MlpDims, device: torch.device) -> int:
    """Rows a K2 block runs for `dims` on the CUDA `device`: 16 times the
    most warps, of 8, 4, 2, 1, whose padded weights and input rows fit the
    block's shared memory on that card (`frag_tile_warps` against its
    opt-in limit, asked once per shape and card), or 0 when none does: the
    gate every fused MLP kernel's wrapper checks. K3 shares the layout; K5,
    K6 and K9 choose their own tiles (`mlp_bwd_tile`, `bwd_tile`)."""
    dims.check_fused()
    return _tile_rows(dims, device.index)


@functools.lru_cache(maxsize=None)
def _tile_rows(dims: MlpDims, index: int) -> int:
    fn = _build.library().tcnn_mlp_tile
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn(dims.in_w, dims.width, dims.n_hidden, dims.out_w, index)


def frag_tile_smem_bytes(dims: MlpDims, warps: int) -> int:
    """Shared memory of a K2 or K3 block of `warps` warps
    (csrc/mlp_frag.cuh counts the same): the padded weights
    (`frag_weight_elems`), then each warp's 16 input rows (K3: encoded
    rows) at a pitch of in_w + 8, all bf16."""
    return 2 * (frag_weight_elems(dims) + warps * 16 * (dims.in_w + 8))


def frag_tile_warps(dims: MlpDims) -> int:
    """Warps of a K2 or K3 block: the most of 8, 4, 2, 1 whose shared
    memory fits SMEM_OPTIN, else 0. The C side makes the same choice
    against the card's own opt-in limit."""
    for warps in (8, 4, 2, 1):
        if frag_tile_smem_bytes(dims, warps) <= SMEM_OPTIN:
            return warps
    return 0


def _weights(dims: MlpDims, weights):
    """The f32 [fan_out, fan_in] matrices of the flat bf16 weights."""
    mats, off = [], 0
    for r, c in dims.layer_sizes():
        mats.append(weights[off : off + r * c].view(r, c).float())
        off += r * c
    return mats


def _forward_keep(dims: MlpDims, mats, x):
    """Every layer's output of the fused chain, as f32 holding bf16 values:
    bf16 inputs and weights, f32 products and sums, the activation in f32,
    bf16 between layers. hs[0] is the input."""
    hs = [x.float()]
    for i, w in enumerate(mats):
        act = dims.output_activation if i == len(mats) - 1 else dims.activation
        hs.append(activation_fn(hs[-1] @ w.T, act).to(torch.bfloat16).float())
    return hs


def _mlp_forward_plain(dims: MlpDims, weights, x):
    """What K2 computes, in plain PyTorch on any device."""
    return _forward_keep(dims, _weights(dims, weights), x)[-1].to(torch.bfloat16)


def _mlp_backward_plain(dims: MlpDims, weights, x, gy):
    """What K5 computes, in plain PyTorch on any device: (gW f32
    [n_weights] in the flat layout, gx bf16 [B, in_w])."""
    mats = _weights(dims, weights)
    hs = _forward_keep(dims, mats, x)
    g = gy.float()
    grads = [None] * len(mats)
    for i in reversed(range(len(mats))):
        act = dims.output_activation if i == len(mats) - 1 else dims.activation
        g = activation_bwd_out(g, hs[i + 1], act).to(torch.bfloat16).float()
        grads[i] = (g.T @ hs[i]).reshape(-1)
        g = g @ mats[i]
    return torch.cat(grads), g.to(torch.bfloat16)


def mlp_forward(dims: MlpDims, weights, x):
    """x [B, in_w] bf16 -> [B, out_w] bf16 through the fused MLP.
    `weights` is the flat bf16 weight vector (mlp.py:16-20 layout)."""
    B = check_mlp_inputs(dims, weights, x)
    if x.device.type == "cpu":
        return _mlp_forward_plain(dims, weights, x)
    out = torch.empty((B, dims.out_w), dtype=torch.bfloat16, device=x.device)
    if B == 0:
        return out
    fn = _build.function("tcnn_mlp_fwd", _MLP_FWD_ARGS)
    _build.check(
        fn(
            x.data_ptr(), weights.data_ptr(), out.data_ptr(), B, *dims.c_args(),
            x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
        ),
        "tcnn_mlp_fwd",
    )
    profiling.count("launches.K2")
    return out


_MLP_FWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def bwd_smem_bytes(dims: MlpDims, nt: int, ig_floats: int = 0, priv_floats: int = 0) -> int:
    """Shared memory of a K6 or K9 block of nt rows, for the gate that
    picks the tile before any device is asked (the launch takes its bytes
    from csrc/fused_train.cuh's TrainLayout, the same count, and opts in to
    them there): the padded weights (`frag_weight_elems`), the kept bf16
    outputs h_0 (the encoding, pitch in_w + 8) and h_1..h_H (pitch
    width + 8), the output layer's gradient as bf16 hi and lo (pitch
    out_w + 8), two gradient tiles of hi and lo (pitch width + 8), the
    second at least the f32 encoding gradient (pitch in_w + 1), K9's
    `ig_floats` f32 per row (its dL/dx partials, L * D) and K6's
    `priv_floats` f32 of private table gradient
    (`train_kernel.train_layout`)."""
    kept = (dims.in_w + 8) + dims.n_hidden * (dims.width + 8)
    g_tile = 2 * 2 * nt * (dims.width + 8)
    return (
        2 * frag_weight_elems(dims)
        + 2 * nt * kept
        + 2 * 2 * nt * (dims.out_w + 8)
        + g_tile + max(g_tile, 4 * nt * (dims.in_w + 1))
        + 4 * nt * ig_floats
        + 4 * priv_floats
    )


def bwd_tile(dims: MlpDims, ig_floats: int = 0, max_nt: int = 128) -> int:
    """Rows per block of K6/K9: the largest of 128, 64, 32, 16 up to
    `max_nt` whose shared memory fits SMEM_OPTIN, else 0."""
    for nt in (128, 64, 32, 16):
        if nt <= max_nt and bwd_smem_bytes(dims, nt, ig_floats) <= SMEM_OPTIN:
            return nt
    return 0


def frag_weight_elems(dims: MlpDims) -> int:
    """Elements of the weights in K2's, K3's, K5's, K6's and K9's shared memory
    (csrc/mlp_frag.cuh): each layer's [fan_out, fan_in] at a row pitch of
    fan_in + 8, so that ldmatrix's eight rows fall in distinct banks."""
    return sum(r * (c + 8) for r, c in dims.layer_sizes())


def mlp_bwd_smem_bytes(dims: MlpDims, nt: int) -> int:
    """Shared memory of a K5 block of nt rows (csrc/mlp_bwd.cu:K5Layout,
    the same count): the padded weights, the kept bf16 outputs h_0 (the
    input, pitch in_w + 8) and h_1..h_H (pitch width + 8), and two bf16
    gradient buffers of pitch max(width, out_w) + 8."""
    ld_g = max(dims.width, dims.out_w) + 8
    kept = (dims.in_w + 8) + dims.n_hidden * (dims.width + 8)
    return 2 * (frag_weight_elems(dims) + nt * kept + 2 * nt * ld_g)


def mlp_bwd_tile(dims: MlpDims) -> int:
    """Rows per K5 block: the largest of 128, 64, 32, 16 whose shared
    memory fits SMEM_OPTIN, else 0."""
    for nt in (128, 64, 32, 16):
        if mlp_bwd_smem_bytes(dims, nt) <= SMEM_OPTIN:
            return nt
    return 0


#: K5 takes its split plan where the resident plan's tile (`mlp_bwd_tile`)
#: is under this many rows: fewer than 4 warps a block, one block an SM.
SPLIT_BELOW_ROWS = 64
#: The split plan's weight-gradient kernel (csrc/mlp_bwd_split.cu): rows a
#: cp.async stage, stages, warps a block and a warp's rectangle of 16x16
#: units (unit rows, unit columns).
WGRAD_ROWS = 64
WGRAD_STAGES = 3
WGRAD_WARPS = 16
WGRAD_RECT = (2, 2)


def mlp_bwd_plan(dims: MlpDims) -> str:
    """K5's plan for `dims`, from the shape alone: "split" where the
    resident plan's tile is under SPLIT_BELOW_ROWS rows, else "resident"."""
    return "split" if mlp_bwd_tile(dims) < SPLIT_BELOW_ROWS else "resident"


def mlp_dgrad_smem_bytes(dims: MlpDims, warps: int) -> int:
    """Shared memory of a split-plan dgrad block of `warps` warps
    (csrc/mlp_bwd_split.cu:dgrad_smem_bytes): the padded weights, then each
    warp's 16 input rows (pitch in_w + 8) and 16 rows of the output layer's
    gradient (pitch out_w + 8), bf16, and the signs of its rows of each
    hidden layer's output, 8 bytes a lane (256 a layer)."""
    slice_ = 2 * (16 * (dims.in_w + 8) + 16 * (dims.out_w + 8)) + 256 * dims.n_hidden
    return 2 * frag_weight_elems(dims) + warps * slice_


def mlp_dgrad_warps(dims: MlpDims) -> int:
    """Warps of a split-plan dgrad block: the most of 8, 4, 2, 1 that fit
    SMEM_OPTIN, else 0 (the C side asks the card's own limit)."""
    for warps in (8, 4, 2, 1):
        if mlp_dgrad_smem_bytes(dims, warps) <= SMEM_OPTIN:
            return warps
    return 0


def mlp_wgrad_smem_bytes(dims: MlpDims) -> int:
    """Shared memory of a split-plan weight-gradient block
    (csrc/mlp_bwd_split.cu:wgrad_smem_bytes): WGRAD_STAGES stages of
    WGRAD_ROWS rows of G (pitch widest fan_out + 8) and of h (pitch widest
    fan_in + 8), bf16."""
    fo = max(dims.width, dims.out_w)
    fi = max(dims.width, dims.in_w)
    return 2 * WGRAD_STAGES * WGRAD_ROWS * (fo + 8 + fi + 8)


def mlp_bwd_split_scratch(dims: MlpDims, B: int):
    """(h, G) bf16 elements the split plan's wrapper allocates for B rows:
    h_1..h_H [B, width] each; G_0..G_{H-1} [B, width] and G_H [B, out_w]."""
    kept = dims.n_hidden * B * dims.width
    return kept, kept + B * dims.out_w


def persistent_grid(entry: str, args, device) -> int:
    """The persistent grid of K4 (`tcnn_grid_bwd_grid`), K5
    (`tcnn_mlp_bwd_grid`; its split plan's weight gradient:
    `tcnn_mlp_bwd_split_grid`), K6 (`tcnn_fused_train_grid`) or K9
    (`tcnn_fused_ig_grid`), as the C side chooses it from the kernel's
    occupancy: the blocks resident at once, never more than the tiles. The
    wrapper sizes the per-block partials by it and passes it to the
    launch."""
    fn = _build.function(entry, [ctypes.c_int] * (len(args) + 1))
    grid = fn(*args, device.index)
    if grid < 0:
        _build.check(-grid, entry)
    if grid == 0:
        raise ValueError(f"{entry}{tuple(args)}: no block fits the card's shared memory")
    return grid


def mlp_backward(dims: MlpDims, weights, x, gy):
    """(gW f32 [n_weights], gx bf16 [B, in_w]) of the fused MLP at the bf16
    input `x` [B, in_w] for the bf16 cotangent `gy` [B, out_w]."""
    B = check_mlp_inputs(dims, weights, x)
    if gy.dtype != torch.bfloat16 or tuple(gy.shape) != (B, dims.out_w):
        raise ValueError(f"gy must be bfloat16 [{B}, {dims.out_w}], got {gy.dtype} {tuple(gy.shape)}")
    if gy.device != x.device:
        raise ValueError(f"gy on {gy.device}, x on {x.device}")
    if x.device.type == "cpu":
        return _mlp_backward_plain(dims, weights, x, gy)
    if not gy.is_contiguous():
        raise ValueError("gy must be contiguous")
    if mlp_bwd_plan(dims) == "split":
        return _mlp_backward_split(dims, weights, x, gy, B)
    return _mlp_backward_resident(dims, weights, x, gy, B)


def _mlp_backward_resident(dims: MlpDims, weights, x, gy, B: int):
    """K5's resident plan on the card: one kernel, then the fixed-order sum
    of its blocks' partials."""
    nt = mlp_bwd_tile(dims)
    if nt == 0:
        raise ValueError(f"fused MLP {dims} does not fit the backward kernel's shared memory")
    gw = torch.zeros(dims.n_weights, dtype=torch.float32, device=x.device)
    gx = torch.empty((B, dims.in_w), dtype=torch.bfloat16, device=x.device)
    if B == 0:
        return gw, gx
    grid = persistent_grid("tcnn_mlp_bwd_grid", (B, nt, *dims.c_args()), x.device)
    partials = torch.empty(grid * dims.n_weights, dtype=torch.float32, device=x.device)
    fn = _build.function("tcnn_mlp_bwd", _MLP_BWD_ARGS)
    _build.check(
        fn(
            x.data_ptr(), gy.data_ptr(), weights.data_ptr(), gw.data_ptr(), gx.data_ptr(),
            partials.data_ptr(), grid, B, nt, *dims.c_args(), x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream,
        ),
        "tcnn_mlp_bwd",
    )
    profiling.count("launches.K5")
    return gw, gx


_MLP_BWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def _mlp_backward_split(dims: MlpDims, weights, x, gy, B: int):
    """K5's split plan on the card: dgrad, the split-K weight gradient into
    per-block partials and their fixed-order sum (one C call, three
    launches), with the kept outputs and every layer's G in scratch."""
    if mlp_dgrad_warps(dims) == 0:
        raise ValueError(f"fused MLP {dims} does not fit the backward kernel's shared memory")
    dev = x.device
    gx = torch.empty((B, dims.in_w), dtype=torch.bfloat16, device=dev)
    if B == 0:
        return torch.zeros(dims.n_weights, dtype=torch.float32, device=dev), gx
    gw = torch.empty(dims.n_weights, dtype=torch.float32, device=dev)
    n_h, n_g = mlp_bwd_split_scratch(dims, B)
    h = torch.empty(n_h, dtype=torch.bfloat16, device=dev)
    g = torch.empty(n_g, dtype=torch.bfloat16, device=dev)
    grid = persistent_grid("tcnn_mlp_bwd_split_grid", (B, *dims.c_args()), dev)
    partials = torch.empty(grid * dims.n_weights, dtype=torch.float32, device=dev)
    fn = _build.function("tcnn_mlp_bwd_split", _MLP_BWD_SPLIT_ARGS)
    _build.check(
        fn(
            x.data_ptr(), gy.data_ptr(), weights.data_ptr(), gw.data_ptr(), gx.data_ptr(),
            h.data_ptr(), g.data_ptr(), partials.data_ptr(), grid, B, *dims.c_args(),
            dev.index, torch.cuda.current_stream(dev).cuda_stream,
        ),
        "tcnn_mlp_bwd_split",
    )
    profiling.count("launches.K5")
    profiling.count("k5.split")
    return gw, gx


_MLP_BWD_SPLIT_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


class FusedMlpFn(torch.autograd.Function):
    """The fully fused MLP as an autograd Function of its f32 params slice
    (counterpart of ``_fused_mlp`` and its custom vjp, mlp_kernel.py:
    174-192): the params are cast to bf16 inside `forward`, so the weight
    gradient comes back in f32; the input gradient comes back as bf16."""

    @staticmethod
    def forward(ctx, params, x, dims):
        weights = params.to(torch.bfloat16).contiguous()
        xb = x.to(torch.bfloat16).contiguous()
        ctx.save_for_backward(weights, xb)
        ctx.dims, ctx.x_dtype = dims, x.dtype
        return mlp_forward(dims, weights, xb)

    @staticmethod
    def backward(ctx, gy):
        weights, xb = ctx.saved_tensors
        gw, gx = mlp_backward(ctx.dims, weights, xb, gy.to(torch.bfloat16).contiguous())
        return gw, gx.to(ctx.x_dtype), None


def check_mlp_inputs(dims: MlpDims, weights, x=None) -> int:
    """Device/dtype/shape/contiguity checks shared by K2, K3, K5 and K6;
    returns B (0 when `x` is None)."""
    if weights.dtype != torch.bfloat16 or tuple(weights.shape) != (dims.n_weights,):
        raise ValueError(
            f"weights must be bfloat16 [{dims.n_weights}], "
            f"got {weights.dtype} {tuple(weights.shape)}"
        )
    if x is not None:
        if x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != dims.in_w:
            raise ValueError(
                f"x must be bfloat16 [B, {dims.in_w}], got {x.dtype} {tuple(x.shape)}"
            )
        if weights.device != x.device:
            raise ValueError(f"weights on {weights.device}, x on {x.device}")
    dev = weights.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        dims.check_fused()
        for t in (weights,) if x is None else (weights, x):
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("kernel operands must be contiguous and 16-byte aligned")
        if tile_rows(dims, dev) == 0:
            raise ValueError(
                f"fused MLP {dims} does not fit the block's shared memory at any tile"
            )
    return 0 if x is None else x.shape[0]
