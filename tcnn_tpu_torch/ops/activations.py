"""Activation functions with reference-exact semantics.

Counterpart of ``tcnn_tpu/ops/activations.py:19-104`` (warp_activation and
warp_activation_backward, common_device.h:102-304), including the K_ACT=10
"zoom" of Squareplus/Softplus and the 0.01 LeakyReLU slope. The CUDA
kernels apply the same formulas in f32 (csrc/mlp_common.cuh).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..common import Activation, K_ACT

#: Integer codes the CUDA kernels take for each activation (Sine has none:
#: the fused kernels do not run it, fully_fused_mlp.cu:681-705).
ACTIVATION_CODES = {
    Activation.NONE: 0,
    Activation.ReLU: 1,
    Activation.LeakyReLU: 2,
    Activation.Exponential: 3,
    Activation.Sigmoid: 4,
    Activation.Squareplus: 5,
    Activation.Softplus: 6,
    Activation.Tanh: 7,
}


def activation_fn(x: torch.Tensor, act: Activation) -> torch.Tensor:
    """Forward activation (common_device.h:102-165)."""
    if act == Activation.NONE:
        return x
    if act == Activation.ReLU:
        return torch.clamp_min(x, 0)
    if act == Activation.LeakyReLU:
        return torch.where(x > 0, x, 0.01 * x)
    if act == Activation.Exponential:
        return torch.exp(x)
    if act == Activation.Sine:
        return torch.sin(x)
    if act == Activation.Sigmoid:
        return torch.sigmoid(x)
    if act == Activation.Squareplus:
        xk = x * K_ACT
        return 0.5 * (xk + torch.sqrt(xk * xk + 4.0)) / K_ACT
    if act == Activation.Softplus:
        return F.softplus(x * K_ACT) / K_ACT
    if act == Activation.Tanh:
        return torch.tanh(x)
    raise ValueError(f"Unsupported activation {act}")


def activation_bwd_out(grad: torch.Tensor, post_act: torch.Tensor, act: Activation):
    """grad * act'(x) from the post-activation output (warp_activation_backward,
    common_device.h:237-304): the form the fused backward kernels use, since
    they keep only the activated values. Sine has none (cutlass_mlp.cu:101-113)."""
    if act == Activation.NONE:
        return grad
    if act == Activation.ReLU:
        return grad * (post_act > 0)
    if act == Activation.LeakyReLU:
        return grad * torch.where(post_act > 0, 1.0, 0.01)
    if act == Activation.Exponential:
        return grad * post_act
    if act == Activation.Sigmoid:
        return grad * post_act * (1.0 - post_act)
    if act == Activation.Squareplus:
        y = post_act * K_ACT
        y2 = y * y
        return grad * (y2 / (y2 + 1.0))
    if act == Activation.Softplus:
        return grad * (1.0 - torch.exp(-post_act * K_ACT))
    if act == Activation.Tanh:
        return grad * (1.0 - post_act * post_act)
    raise ValueError(f"Activation {act} cannot be differentiated from its output alone")
