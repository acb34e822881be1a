"""Forward activation functions with reference-exact semantics.

Counterpart of ``tcnn_tpu/ops/activations.py:19-43`` (warp_activation,
common_device.h:102-165), including the K_ACT=10 "zoom" of
Squareplus/Softplus and the 0.01 LeakyReLU slope. The backward forms come
with the training port. The CUDA kernels apply the same formulas in f32
(csrc/mlp_common.cuh).
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
