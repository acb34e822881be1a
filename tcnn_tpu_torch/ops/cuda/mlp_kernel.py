"""Fully fused MLP forward and backward: kernels K2 (``csrc/mlp_fwd.cu``)
and K5 (``csrc/mlp_bwd.cu``), their plain PyTorch twins, and `FusedMlpFn`,
the autograd Function that joins them.

K2 replaces ``tcnn_tpu/ops/pallas/mlp_kernel.py:_fwd_kernel`` (reached
through ``_fwd_call`` and ``fused_mlp_apply``), K5 its ``_bwd_kernel``
(through ``_bwd_call`` and ``_fused_mlp_bwd``). One block owns a tile of samples;
all layer weights sit in shared memory in the flat parameter layout
(row-major [fan_out, fan_in] per matrix, mlp.py:16-20, y = x·Wᵀ), the
products run on the tensor cores in bf16 with f32 accumulation, and each
layer's activation is applied in f32 and rounded to bf16, as
``mlp_kernel.py:51-62`` does. Sine has no fused form
(``mlp_kernel.py:44-48``); FullyFusedMLP sends it to the matmul chain.

K5 recomputes the forward chain keeping every layer's bf16 output, then
runs the dgrad chain as ``mlp_kernel.py:86-106`` does: g = act'(g) from
the kept output, rounded to bf16, gW += h^T g in f32, g = g W; the input
gradient leaves as bf16. Weight gradients come out in the params slice's
own flat row-major [fan_out, fan_in] layout, with no transpose.

`mlp_forward` and `mlp_backward` take the plain twin for a CPU tensor and
the kernel for a CUDA tensor; there is no other route.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ...common import Activation
from ..activations import ACTIVATION_CODES, activation_bwd_out, activation_fn
from . import _build

#: Launches of K2 and of K5 since the last reset (counted where each kernel
#: launches).
LAUNCHES = 0
BWD_LAUNCHES = 0

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
    """Rows per block the CUDA kernels K2 and K3 run for `dims` on the
    CUDA `device`: the largest of 128, 64, 32, 16 whose weights, two
    activation buffers and accumulator scratch fit the block's shared
    memory, or 0 when none does."""
    dims.check_fused()
    fn = _build.library().tcnn_mlp_tile
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn(dims.in_w, dims.width, dims.n_hidden, dims.out_w, device.index)


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
    global LAUNCHES
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
    LAUNCHES += 1
    return out


_MLP_FWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def bwd_smem_bytes(dims: MlpDims, nt: int, split: bool, ig_floats: int = 0,
                   priv_floats: int = 0) -> int:
    """Shared memory of a K5 (split=False), K6 or K9 (split=True) block of
    nt rows, for the gate that picks the tile before any device is asked
    (the launch takes its bytes from csrc/mlp_bwd_common.cuh's BwdLayout,
    the same count, and opts in to them there): the weights, every layer's
    kept bf16 output (row pitch = width + 8), two gradient tiles (bf16, and
    a second bf16 for the low half of the split f32 gradient in K6/K9) of
    pitch max(in_w, width, out_w) + 8, a 16x16 f32 scratch per warp, K9's
    `ig_floats` f32 per row (its dL/dx partials, L * D) and K6's
    `priv_floats` f32 of private table gradient
    (`train_kernel.train_layout`)."""
    ld_g = max(dims.in_w, dims.width, dims.out_w) + 8
    kept = (dims.in_w + 8) + dims.n_hidden * (dims.width + 8) + (dims.out_w + 8)
    return (
        2 * dims.n_weights
        + 2 * nt * kept
        + 2 * (2 if split else 1) * 2 * nt * ld_g
        + (nt // 16) * 256 * 4
        + 4 * nt * ig_floats
        + 4 * priv_floats
    )


def bwd_tile(dims: MlpDims, split: bool, ig_floats: int = 0) -> int:
    """Rows per block of K5/K6/K9: the largest of 128, 64, 32, 16 whose
    shared memory fits SMEM_OPTIN, else 0."""
    for nt in (128, 64, 32, 16):
        if bwd_smem_bytes(dims, nt, split, ig_floats) <= SMEM_OPTIN:
            return nt
    return 0


def persistent_grid(entry: str, args, device) -> int:
    """The persistent grid of K4 (`tcnn_grid_bwd_grid`), K5
    (`tcnn_mlp_bwd_grid`), K6 (`tcnn_fused_train_grid`) or K9
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
    nt = bwd_tile(dims, split=False)
    if nt == 0:
        raise ValueError(f"fused MLP {dims} does not fit the backward kernel's shared memory")
    global BWD_LAUNCHES
    gw = torch.zeros(dims.n_weights, dtype=torch.float32, device=x.device)
    gx = torch.empty((B, dims.in_w), dtype=torch.bfloat16, device=x.device)
    if B == 0:
        return gw, gx
    grid = persistent_grid("tcnn_mlp_bwd_grid", (B, nt, *dims.c_args()[:4]), x.device)
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
    BWD_LAUNCHES += 1
    return gw, gx


_MLP_BWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


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
