"""MLP networks (counterpart of ``tcnn_tpu/models/mlp.py``).

  - `CutlassMLP` (otype "CutlassMLP"/"MLP"): arbitrary widths, >= 0 hidden
    layers, as a chain of `torch.matmul`s differentiated by torch autograd
    (the JAX package leaves it to XLA).
  - `FullyFusedMLP` (otype "FullyFusedMLP"): widths {16, 32, 64, 128},
    through `mlp_kernel.FusedMlpFn`: kernel K2 forward, kernel K5 backward
    (``ops/cuda/mlp_kernel.py``). Sine has no fused form
    (mlp_kernel.py:44-48) and takes the matmul chain, and so does a
    `second_order` apply (the input-gradient path).

`compute_dtype` bf16 (the default) rounds operands and layer outputs to
bf16; torch.float32 runs CutlassMLP's matmul chain in f32 with no
rounding, as the JAX package's `jnp.dot(..., preferred_element_type=f32)`
chain computes at f32 (mlp.py:98-108). FullyFusedMLP at f32 keeps K2 and
K5 on a CUDA tensor, its bf16 output cast to f32, as the JAX package keeps
its Pallas kernel on a TPU (mlp.py:153-167), and takes the f32 chain on a
CPU tensor, as the JAX package does off a TPU (`common.plain_route`).

Parameter layout (flat fp32, row-major per matrix, fully_fused_mlp.cu:659-677):
    [W_in (width x input_width), W_hidden_1..H-1 (width x width),
     W_out (padded_output_width x width)]
A weight matrix W of shape [rows=fan_out, cols=fan_in] maps y = x @ W^T.

Initialization (gpu_matrix.h:284-379, fully_fused_mlp.cu:866-891):
Xavier-uniform U(+-sqrt(6/(fan_in+fan_out))) normally; for Sine, SIREN
init: first layer U(+-30/fan_in), others U(+-sqrt(6/fan_in)).
"""

from __future__ import annotations

import math

import torch

from .. import common
from ..common import COMPUTE_DTYPE, Activation
from ..ops.activations import activation_fn
from ..ops.cuda import mlp_kernel
from .base import Network


class CutlassMLP(Network):
    """General-width MLP; 0 hidden layers = plain (activated) matmul."""

    def __init__(
        self,
        input_width: int,
        n_output_dims: int,
        n_neurons: int = 128,
        n_hidden_layers: int = 5,
        activation: Activation = Activation.ReLU,
        output_activation: Activation = Activation.NONE,
    ):
        super().__init__(input_width, n_output_dims)
        self.n_neurons = int(n_neurons)
        self.n_hidden_layers = int(n_hidden_layers)
        self.activation = activation
        self.output_activation = output_activation

    # -- layout -----------------------------------------------------------
    def layer_sizes(self):
        w, inp, out = self.n_neurons, self.input_width, self.padded_output_width
        if self.n_hidden_layers == 0:
            return [(out, inp)]
        return [(w, inp)] + [(w, w)] * (self.n_hidden_layers - 1) + [(out, w)]

    @property
    def n_params(self) -> int:
        return sum(r * c for r, c in self.layer_sizes())

    def init_params(self, generator: torch.Generator) -> torch.Tensor:
        parts = []
        for i, (rows, cols) in enumerate(self.layer_sizes()):
            if self.activation == Activation.Sine:
                scale = 30.0 / cols if i == 0 else math.sqrt(6.0 / cols)
            else:
                scale = math.sqrt(6.0 / (cols + rows))
            parts.append(
                torch.empty(rows * cols, dtype=torch.float32).uniform_(
                    -scale, scale, generator=generator
                )
            )
        return torch.cat(parts)

    # -- compute -----------------------------------------------------------
    def apply(self, params, x, second_order=False, compute_dtype=COMPUTE_DTYPE):
        """Operands and layer outputs rounded to `compute_dtype`, f32
        products and activation (mlp.py:98-108); differentiable to any order
        by autograd, so `second_order` changes nothing here. The output is
        in `compute_dtype`."""
        h = x.to(compute_dtype).float()
        off = 0
        sizes = self.layer_sizes()
        for i, (r, c) in enumerate(sizes):
            w = params[off : off + r * c].view(r, c).to(compute_dtype).float()
            off += r * c
            act = self.output_activation if i == len(sizes) - 1 else self.activation
            h = activation_fn(torch.matmul(h, w.T), act).to(compute_dtype).float()
        return h.to(compute_dtype)

    def hyperparams(self):
        return {
            "otype": "CutlassMLP",
            "activation": self.activation.value,
            "output_activation": self.output_activation.value,
            "n_neurons": self.n_neurons,
            "n_hidden_layers": self.n_hidden_layers,
        }


class FullyFusedMLP(CutlassMLP):
    """Width-restricted MLP run by the fused kernel K2."""

    SUPPORTED_WIDTHS = mlp_kernel.FUSED_WIDTHS

    def __init__(
        self,
        input_width: int,
        n_output_dims: int,
        n_neurons: int = 128,
        n_hidden_layers: int = 5,
        activation: Activation = Activation.ReLU,
        output_activation: Activation = Activation.NONE,
    ):
        if n_neurons not in self.SUPPORTED_WIDTHS:
            raise ValueError(
                f"FullyFusedMLP only supports widths {self.SUPPORTED_WIDTHS}; "
                f"got {n_neurons}. Use CutlassMLP instead."
            )
        if n_hidden_layers <= 0:
            # fully_fused_mlp.cu:650-652
            raise ValueError("FullyFusedMLP requires at least 1 hidden layer")
        super().__init__(
            input_width, n_output_dims, n_neurons, n_hidden_layers,
            activation, output_activation,
        )

    @property
    def dims(self) -> mlp_kernel.MlpDims:
        return mlp_kernel.MlpDims(
            self.input_width, self.n_neurons, self.n_hidden_layers,
            self.padded_output_width, self.activation, self.output_activation,
        )

    def apply(self, params, x, second_order=False, compute_dtype=COMPUTE_DTYPE):
        """K2 forward and K5 backward, the output cast to `compute_dtype`;
        `second_order` (the input-gradient path, whose gradient is
        differentiated again) takes the matmul chain under autograd
        instead, as tcnn_tpu does (mlp.py:153-170): K5's backward is not
        differentiable. So does a compute dtype other than bf16 on a CPU
        tensor (`common.plain_route`)."""
        if (second_order or common.plain_route(x, compute_dtype)
                or Activation.Sine in (self.activation, self.output_activation)):
            return super().apply(params, x, compute_dtype=compute_dtype)
        return mlp_kernel.FusedMlpFn.apply(params, x, self.dims).to(compute_dtype)

    def hyperparams(self):
        hp = super().hyperparams()
        hp["otype"] = "FullyFusedMLP"
        return hp
