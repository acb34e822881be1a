"""Fully fused MLP forward: kernel K2 (``csrc/mlp_fwd.cu``) and its plain
PyTorch twin.

Replaces ``tcnn_tpu/ops/pallas/mlp_kernel.py:_fwd_kernel`` (reached through
``_fwd_call`` and ``fused_mlp_apply``). One block owns a tile of samples;
all layer weights sit in shared memory in the flat parameter layout
(row-major [fan_out, fan_in] per matrix, mlp.py:16-20, y = x·Wᵀ), the
products run on the tensor cores in bf16 with f32 accumulation, and each
layer's activation is applied in f32 and rounded to bf16, as
``mlp_kernel.py:51-62`` does. Sine has no fused form
(``mlp_kernel.py:44-48``); FullyFusedMLP sends it to the matmul chain.

`mlp_forward` takes the plain twin for a CPU tensor and the kernel for a
CUDA tensor; there is no other route.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ...common import Activation
from ..activations import ACTIVATION_CODES, activation_fn
from . import _build

#: Launches of K2 since the last reset (counted where the kernel launches).
LAUNCHES = 0

FUSED_WIDTHS = (16, 32, 64, 128)


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


def _mlp_forward_plain(dims: MlpDims, weights, x):
    """What K2 computes, in plain PyTorch on any device: bf16 inputs and
    weights, f32 products and sums, the activation in f32, bf16 between
    layers and at the output."""
    h = x.float()
    off = 0
    sizes = dims.layer_sizes()
    for i, (r, c) in enumerate(sizes):
        w = weights[off : off + r * c].view(r, c).float()
        off += r * c
        act = dims.output_activation if i == len(sizes) - 1 else dims.activation
        h = activation_fn(h @ w.T, act).to(torch.bfloat16).float()
    return h.to(torch.bfloat16)


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


def check_mlp_inputs(dims: MlpDims, weights, x=None) -> int:
    """Device/dtype/shape/contiguity checks shared by K2 and K3; returns B
    (0 when `x` is None)."""
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
