"""Core definitions shared across the port.

PyTorch counterpart of ``tcnn_tpu/common.py``: the enums, their
case-insensitive parsers, the padding constants and the precision policy
(fp32 master parameters, bf16 compute by default; f32 compute where the
caller asks for it, `plain_route`).
"""

from __future__ import annotations

import enum
import math

import torch

#: Batch granularity of the reference (common.h:235 uses 256; the JAX
#: package pads to 128). The port's kernels mask a ragged batch tail, so
#: only the module API pads to it, as the JAX package's does.
BATCH_SIZE_GRANULARITY = 128

#: Loss scale of half-precision compute (common.h:229-233): multiplied into
#: the loss gradient, divided out by the optimizer.
DEFAULT_LOSS_SCALE = 128.0
#: Loss scale of full-precision compute (common.h:229-233): none.
DEFAULT_LOSS_SCALE_FLOAT = 1.0

#: "Zoom" factor of Squareplus/Softplus activations (K_ACT, common_device.h:100).
K_ACT = 10.0

#: The width every network output is padded to a multiple of (the reference's
#: tensor-core fragment width; object.h / fully_fused_mlp.cu:656).
OUTPUT_WIDTH_ALIGNMENT = 16

#: Maximum number of grid levels (grid_interface.h:84-88).
MAX_N_LEVELS = 128

PI = math.pi

#: Network compute precision (master parameters stay fp32); the kernels
#: take bf16 operands. At another dtype (torch.float32) the grid and
#: FullyFusedMLP keep their kernels on a CUDA tensor, as tcnn_tpu keeps
#: its Pallas kernels on a TPU, and take the plain route on a CPU tensor
#: (`plain_route`).
COMPUTE_DTYPE = torch.bfloat16


def plain_route(x: torch.Tensor, compute_dtype) -> bool:
    """Whether the grid and FullyFusedMLP leave their kernels for the plain
    route at `compute_dtype`: only at a dtype other than bf16 and on a CPU
    tensor, where the route computes what tcnn_tpu computes off a TPU (its
    XLA route: the f32 gather and the f32 matmul chain). On a CUDA tensor
    the kernels run and their bf16 outputs are cast to `compute_dtype`, as
    tcnn_tpu's Pallas kernels are on a TPU (grid.py:316-343,
    mlp.py:153-167)."""
    return compute_dtype != COMPUTE_DTYPE and x.device.type == "cpu"


def default_loss_scale(compute_dtype=COMPUTE_DTYPE) -> float:
    """The loss scale of `compute_dtype` (tcnn_tpu/common.py:147): 128 for a
    half-precision type, 1 for f32."""
    if compute_dtype in (torch.float16, torch.bfloat16):
        return DEFAULT_LOSS_SCALE
    return DEFAULT_LOSS_SCALE_FLOAT


class Activation(enum.Enum):
    ReLU = "ReLU"
    LeakyReLU = "LeakyReLU"
    Exponential = "Exponential"
    Sine = "Sine"
    Sigmoid = "Sigmoid"
    Squareplus = "Squareplus"
    Softplus = "Softplus"
    Tanh = "Tanh"
    NONE = "None"


class GridType(enum.Enum):
    Hash = "Hash"
    Dense = "Dense"
    Tiled = "Tiled"


class HashType(enum.Enum):
    Prime = "Prime"
    CoherentPrime = "CoherentPrime"
    ReversedPrime = "ReversedPrime"
    Rng = "Rng"


class InterpolationType(enum.Enum):
    Nearest = "Nearest"
    Linear = "Linear"
    Smoothstep = "Smoothstep"


class ReductionType(enum.Enum):
    Concatenation = "Concatenation"
    Sum = "Sum"
    Product = "Product"


class GradientMode(enum.Enum):
    """How `Module.bwd` treats parameter gradients (object.h:115-119)."""

    Ignore = "Ignore"
    Overwrite = "Overwrite"
    Accumulate = "Accumulate"


def _parse_enum(enum_cls, value, what):
    if isinstance(value, enum_cls):
        return value
    if isinstance(value, str):
        for member in enum_cls:
            if member.value.lower() == value.lower():
                return member
    raise ValueError(f"Invalid {what}: {value!r}")


def parse_activation(value) -> Activation:
    return _parse_enum(Activation, value, "activation")


def parse_grid_type(value) -> GridType:
    return _parse_enum(GridType, value, "grid type")


def parse_hash_type(value) -> HashType:
    return _parse_enum(HashType, value, "hash type")


def parse_interpolation_type(value) -> InterpolationType:
    return _parse_enum(InterpolationType, value, "interpolation type")


def parse_reduction_type(value) -> ReductionType:
    return _parse_enum(ReductionType, value, "reduction type")


def div_round_up(a: int, b: int) -> int:
    return -(-a // b)


def next_multiple(a: int, b: int) -> int:
    return div_round_up(a, b) * b


def smoothstep(v):
    """val^2 (3 - 2 val) - common_device.h:802-804, evaluated as
    (v*v) * (3 - 2*v) like the JAX package."""
    return v * v * (3.0 - 2.0 * v)


def quartic_cdf(x, inv_radius):
    """CDF of the quartic kernel (common_device.h:911-917), clamped to
    [0, 1]: its gradient is zero where the clamp binds, as jnp.clip's is."""
    u = x * inv_radius
    u2 = u * u
    u4 = u2 * u2
    return torch.clamp(
        (15.0 / 16.0) * u * (1.0 - (2.0 / 3.0) * u2 + (1.0 / 5.0) * u4) + 0.5, 0.0, 1.0)


def quartic_cdf_deriv(x, inv_radius):
    """The quartic kernel itself: d quartic_cdf / dx inside the support."""
    u = x * inv_radius
    tmp = torch.clamp(1.0 - u * u, min=0.0)
    return (15.0 / 16.0) * tmp * tmp * inv_radius
