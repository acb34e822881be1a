"""Fused grid + MLP inference: kernel K3 (``csrc/fused_infer.cu``), its
plain PyTorch twin, and the prepared operands it runs from.

Replaces ``tcnn_tpu/ops/pallas/train_kernel.py:_infer_kernel_vt`` (reached
through ``fused_forward_prepared`` from ``Trainer.inference``). Per tile of
samples, K1's gather fills an encoded tile [nt, enc_pad] bf16 in shared
memory and K2's layer chain runs from there, so the encoding never touches
device memory. The training kernels of this module come with the training
port.

The layout is carried explicitly: `prepare_forward` returns a
`PreparedForward` that holds the grid plan, the MLP shape and the bf16
operands, and `fused_forward_prepared` reads nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ...common import Activation
from . import _build
from .grid_kernel import (
    INTERP_CODES,
    GridPlan,
    _check_inputs,
    _grid_encode_plain,
)
from .mlp_kernel import MlpDims, _mlp_forward_plain, check_mlp_inputs

#: Launches of K3 since the last reset (counted where the kernel launches).
LAUNCHES = 0


def fused_plan_for(model):
    """Shape gate of the fused kernels (train_kernel.py:200-217): a
    grid + FullyFusedMLP model without Sine. Returns the grid plan, or None
    when inference must take the composed path."""
    from ...models.mlp import FullyFusedMLP
    from ...models.network_with_input_encoding import NetworkWithInputEncoding
    from ..encodings.grid import GridEncoding

    if not isinstance(model, NetworkWithInputEncoding):
        return None
    if not isinstance(model.encoding, GridEncoding):
        return None
    mlp = model.network
    if not isinstance(mlp, FullyFusedMLP):
        return None
    if Activation.Sine in (mlp.activation, mlp.output_activation):
        return None
    return model.encoding.plan


@dataclasses.dataclass(frozen=True)
class PreparedForward:
    """Device-ready operands of the fused forward: the grid plan and MLP
    shape, the bf16 [total_rows, F] table and the flat bf16 weights."""

    plan: GridPlan
    dims: MlpDims
    table: torch.Tensor
    weights: torch.Tensor


def prepare_forward(model, params) -> PreparedForward:
    """Cast the flat fp32 params [network | encoding] to the kernel's
    operands. Splitting this from the call lets repeated inference skip the
    casts (the JAX Trainer caches them the same way, trainer.py:449-465)."""
    plan = fused_plan_for(model)
    if plan is None:
        raise ValueError(f"{model!r} is not a grid + FullyFusedMLP model")
    net_p, enc_p = model.split_params(params)
    return PreparedForward(
        plan=plan,
        dims=model.network.dims,
        table=enc_p.reshape(plan.total_rows, plan.f).to(torch.bfloat16).contiguous(),
        weights=net_p.to(torch.bfloat16).contiguous(),
    )


def _fused_forward_plain(prep: PreparedForward, x):
    """What K3 computes, in plain PyTorch on any device: the grid forward
    into the padded bf16 encoding, then the MLP chain."""
    enc = _grid_encode_plain(prep.plan, prep.table, x, prep.dims.in_w, prep.plan.n_levels)
    return _mlp_forward_plain(prep.dims, prep.weights, enc)


def fused_forward_prepared(prep: PreparedForward, x):
    """x [B, D] f32 -> [B, out_w] bf16 through the fused grid + MLP."""
    B = _check_inputs(prep.plan, prep.table, x)
    check_mlp_inputs(prep.dims, prep.weights)
    if prep.weights.device != x.device:
        raise ValueError(f"weights on {prep.weights.device}, x on {x.device}")
    if prep.dims.in_w < prep.plan.n_levels * prep.plan.f:
        raise ValueError("MLP input narrower than the encoding")
    if x.device.type == "cpu":
        return _fused_forward_plain(prep, x)
    global LAUNCHES
    plan, dims = prep.plan, prep.dims
    out = torch.empty((B, dims.out_w), dtype=torch.bfloat16, device=x.device)
    if B == 0:
        return out
    level_i32, level_f32 = plan.device_consts(x.device)
    fn = _build.function("tcnn_fused_infer", _FUSED_INFER_ARGS)
    _build.check(
        fn(
            x.data_ptr(), prep.table.data_ptr(), level_i32.data_ptr(),
            level_f32.data_ptr(), prep.weights.data_ptr(), out.data_ptr(),
            B, plan.d, plan.f, plan.n_levels, INTERP_CODES[plan.interpolation],
            *plan.c_factors(), *dims.c_args(), x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream,
        ),
        "tcnn_fused_infer",
    )
    LAUNCHES += 1
    return out


_FUSED_INFER_ARGS = (
    [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 5
    + [ctypes.c_uint32] * 4
    + [ctypes.c_int] * 7
    + [ctypes.c_void_p]
)


def fused_forward(model, params, x):
    """Inference-only fused grid + MLP forward: [B, D] -> [B, out_pad] bf16."""
    return fused_forward_prepared(prepare_forward(model, params), x)
