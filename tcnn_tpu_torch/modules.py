"""The module API: the counterpart of ``tcnn_tpu/modules.py`` and of the
reference's PyTorch extension (bindings/torch/tinycudann/modules.py:209-329).

`NetworkWithInputEncoding`, `Network` and `Encoding` are `torch.nn.Module`s
that

  - hold the flat fp32 parameter vector as one `nn.Parameter` (`.params`)
    on an explicit device (the card unless `device="cpu"`), initialised
    from `torch.Generator().manual_seed(seed)` as the Trainer initialises
    it, so an external optimizer (`torch.optim.Adam(module.parameters())`)
    trains it;
  - pad the batch to BATCH_SIZE_GRANULARITY with 1.0, run the model with
    `prepare_input_gradients=x.requires_grad` (the reference binding's
    flag) and trim rows and output columns to `n_output_dims`, in f32;
  - expose `fwd` / `bwd` with the reference's GradientMode (Overwrite,
    Accumulate, Ignore; object.h:115-119) through `torch.autograd.grad`.

The model underneath is the port's: a grid + FullyFusedMLP module runs K1
-> K2 forward and K5 -> K4 under autograd, and with input gradients K3
forward and K9 backward (`train_kernel.FusedApplyIgFn`). `Network` routes
through an Identity encoding, as the reference's cpp_api does
(src/cpp_api.cu:151-153), so a narrow input is padded with ones to the
network's alignment. Pickling keeps the constructor's arguments and the
params, not the autograd state.
"""

from __future__ import annotations

import inspect

import torch
import torch.nn.functional as F

from .common import BATCH_SIZE_GRANULARITY, GradientMode, next_multiple
from .config import create_network_with_input_encoding
from .registry import create_encoding
from .trainer import resolve_device


class Context:
    """What `fwd` keeps for `bwd`: the params and input it differentiated
    and the output's autograd graph."""

    __slots__ = ("params", "x", "y")

    def __init__(self, params, x, y):
        self.params, self.x, self.y = params, x, y


def _grads(outputs, inputs, cotangent):
    """torch.autograd.grad, keeping the graph for another `bwd`; an input
    the output does not depend on gets zeros."""
    if not outputs.requires_grad:  # a constant output (SH of degree 1)
        return [torch.zeros_like(i) for i in inputs]
    got = torch.autograd.grad(outputs, inputs, cotangent, retain_graph=True, allow_unused=True)
    return [torch.zeros_like(i) if g is None else g for g, i in zip(got, inputs)]


class Module(torch.nn.Module):
    """Stateful parameter holder over one of the port's models."""

    def __init__(self, model, args: dict, seed: int = 1337, output_dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.model = model
        self._args = args
        self.output_dtype = output_dtype
        self.device = resolve_device(device)
        self.params = torch.nn.Parameter(self.initial_params(seed))
        self._accepts_pig = "prepare_input_gradients" in inspect.signature(model.apply).parameters

    # -- pickling (modules.py:194-204 in the reference torch binding) -------
    def __getstate__(self):
        return {"args": self._args, "params": self.params.detach().cpu()}

    def __setstate__(self, state):
        type(self).__init__(self, **state["args"])
        with torch.no_grad():
            self.params.copy_(state["params"])

    def forward(self, x, params=None):
        """x [B, n_input_dims] f32 on the module's device -> f32 [B,
        n_output_dims]; differentiable in `params` (default `.params`) and,
        when x requires a gradient, in x to second order."""
        params = self.params if params is None else params
        if x.device != self.device:
            raise ValueError(f"input on {x.device}, module on {self.device}")
        b = x.shape[0]
        pad = next_multiple(max(b, 1), BATCH_SIZE_GRANULARITY) - b
        x = x.float()
        if pad:
            x = F.pad(x, (0, 0, 0, pad), value=1.0)
        kw = {"prepare_input_gradients": x.requires_grad} if self._accepts_pig else {}
        y = self.model.apply(params, x.contiguous(), **kw)
        return y[:b, : self.n_output_dims].to(self.output_dtype)

    # -- explicit autodiff endpoints (bindings.cpp fwd/bwd) ------------------
    def fwd(self, x, params=None):
        """(y, ctx): the output, detached, and what `bwd` needs. The input
        gradient is prepared, as the reference binding prepares it for an
        x that requires a gradient."""
        p = (self.params if params is None else params).detach().requires_grad_(True)
        xx = x.detach().float().requires_grad_(True)
        with torch.enable_grad():
            y = self.forward(xx, p)
        return y.detach(), Context(p, xx, y)

    def bwd(self, ctx: Context, dL_dy, gradient_mode=None, param_grads=None):
        """(dL_dparams, dL_dinput) for the cotangent dL_dy of `fwd`'s
        output (bindings.cpp:112-171). Overwrite (default) returns fresh
        parameter gradients, Accumulate adds them to `param_grads`, Ignore
        asks autograd for dL/dx alone and returns None for the params."""
        mode = GradientMode.Overwrite if gradient_mode is None else gradient_mode
        dL_dy = dL_dy.to(ctx.y.dtype)
        if mode == GradientMode.Ignore:
            (dx,) = _grads(ctx.y, (ctx.x,), dL_dy)
            return None, dx
        dparams, dx = _grads(ctx.y, (ctx.params, ctx.x), dL_dy)
        if mode == GradientMode.Accumulate:
            if param_grads is None:
                raise ValueError("GradientMode.Accumulate requires param_grads to add into")
            return param_grads + dparams, dx
        return dparams, dx

    @property
    def n_params(self) -> int:
        return self.model.n_params

    def initial_params(self, seed: int = 1337) -> torch.Tensor:
        return self.model.init_params(torch.Generator().manual_seed(int(seed))).to(self.device)

    @property
    def n_output_dims(self) -> int:
        return self.model.n_output_dims

    def hyperparams(self):
        return self.model.hyperparams()


class NetworkWithInputEncoding(Module):
    def __init__(self, n_input_dims: int, n_output_dims: int, encoding_config: dict,
                 network_config: dict, seed: int = 1337, device="cuda"):
        model = create_network_with_input_encoding(
            n_input_dims, n_output_dims, encoding_config, network_config)
        super().__init__(model, dict(n_input_dims=n_input_dims, n_output_dims=n_output_dims,
                                     encoding_config=encoding_config,
                                     network_config=network_config, seed=seed, device=device),
                         seed=seed, device=device)
        self.n_input_dims = int(n_input_dims)


class Network(Module):
    def __init__(self, n_input_dims: int, n_output_dims: int, network_config: dict,
                 seed: int = 1337, device="cuda"):
        model = create_network_with_input_encoding(
            n_input_dims, n_output_dims, {"otype": "Identity"}, network_config)
        super().__init__(model, dict(n_input_dims=n_input_dims, n_output_dims=n_output_dims,
                                     network_config=network_config, seed=seed, device=device),
                         seed=seed, device=device)
        self.n_input_dims = int(n_input_dims)


class Encoding(Module):
    def __init__(self, n_input_dims: int, encoding_config: dict, seed: int = 1337, dtype=None,
                 device="cuda"):
        model = _EncodingModel(create_encoding(n_input_dims, encoding_config))
        super().__init__(model, dict(n_input_dims=n_input_dims, encoding_config=encoding_config,
                                     seed=seed, dtype=dtype, device=device),
                         seed=seed, output_dtype=torch.float32 if dtype is None else dtype,
                         device=device)
        self.n_input_dims = int(n_input_dims)


class _EncodingModel:
    """A bare encoding behind the model interface. An encoding that takes
    `needs_input_grad` (the grid, a Composite) is told whether x requires
    a gradient: the JAX grid defaults to True, the port's to False."""

    def __init__(self, encoding):
        self.encoding = encoding

    @property
    def n_output_dims(self):
        return self.encoding.n_output_dims

    @property
    def n_params(self):
        return self.encoding.n_params

    def layer_sizes(self):
        return self.encoding.layer_sizes()

    def init_params(self, generator):
        return self.encoding.init_params(generator)

    def apply(self, params, x):
        kw = ({"needs_input_grad": x.requires_grad}
              if getattr(self.encoding, "supports_input_grad_opt", False) else {})
        return self.encoding.apply(params, x, **kw)

    def hyperparams(self):
        return self.encoding.hyperparams()
