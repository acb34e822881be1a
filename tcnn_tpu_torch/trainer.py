"""Trainer: owns the model's flat fp32 params, the optimizer state and the
loss; runs training steps and inference.

Counterpart of ``tcnn_tpu/trainer.py`` (the reference's Trainer,
trainer.h:47-361): loss_scale multiplied into the loss gradient and divided
out by the optimizer, data pdf, external dL/doutput, logistic output
perturbation, custom inference weights, and JSON snapshots with the
optimizer state. PyTorch runs eagerly, so a step is a few kernel launches
and the optimizer updates the params in place; `training_step` returns the
loss as a 0-d device tensor and does not synchronise.

Training takes one of two routes, chosen before launch and never after a
failure: a model and loss that `train_kernel.supported` takes run the fused
train kernel K6 (its plain twin on the CPU); every other model runs
`model.apply` under autograd (K1 -> K2 forward, K5 -> K4 backward, or the
matmul chain). `use_fused_train_kernel` = False forces the composed route;
True raises for a model the gate does not take. Targets given as
`ops.volume.Rays` (a NeRF's samples, ray by ray) take the composed route
into the ray loss (`models.nerf.train_grads`): one forward, one backward.

Inference follows the JAX package's dispatch (trainer.py:418-479): a model
that `train_kernel.supported_infer` takes (a grid + FullyFusedMLP model
without Sine and without a max_level clamp) runs the fused kernel K3 on the
inference params (the optimizer's custom weights where it has them), whose
prepared operands are cached on the tensors they derive from; every other
model runs `model.apply` (K1, then K2 or the matmul chain). K3's wrapper
checks the shared memory its tile and weights need and raises when no tile
fits.

`compute_dtype` (bf16 by default) sets the loss scale's default
(`common.default_loss_scale`: 1 at f32) and, at torch.float32, sends
training and inference down the composed route at f32, K6 and K3 not
chosen (trainer.py:146-152): on a CUDA tensor a grid + FullyFusedMLP model
runs K1, K2, K5 and K4 with their bf16 outputs cast to f32, as tcnn_tpu's
Trainer at f32 runs its Pallas kernels on a TPU; on a CPU tensor the
grid's plain route and the MLP's f32 matmul chain (`common.plain_route`),
as tcnn_tpu's runs XLA off a TPU.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .common import COMPUTE_DTYPE, default_loss_scale
from .ops.cuda.train_kernel import (
    fused_forward_prepared,
    fused_train_grads,
    prepare_forward,
    supported,
    supported_infer,
)
from .models import nerf
from .ops.volume import Rays
from .registry import create_loss
from .utils import profiling
from .utils.serialization import (
    array_from_json,
    array_to_json,
    tree_from_json,
    tree_leaves,
    tree_to_json,
)


def resolve_device(device) -> torch.device:
    """A torch.device the port runs on; "cuda" without a GPU raises."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class Trainer:
    def __init__(self, model, optimizer, loss, seed: int = 1337, device="cuda",
                 loss_scale: float | None = None, perturbation_sigma: float = 0.0,
                 compute_dtype=COMPUTE_DTYPE):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.loss_scale = (default_loss_scale(compute_dtype) if loss_scale is None
                           else float(loss_scale))
        self.perturbation_sigma = float(perturbation_sigma)
        #: None: the fused train kernel when `supported`; True/False force.
        self.use_fused_train_kernel: bool | None = None
        self.optimizer.allocate(model.n_params, model.layer_sizes())
        gen = torch.Generator().manual_seed(int(seed))
        self.state = {
            "params": model.init_params(gen).to(self.device),
            "opt": self.optimizer.init_state(self.device),
        }
        #: the perturbation noise's generator, on the model's device
        self.noise_generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self._infer_prepared = None

    @property
    def params(self) -> torch.Tensor:
        return self.state["params"]

    @property
    def inference_params(self) -> torch.Tensor:
        """Custom (averaged) weights when the optimizer provides them
        (trainer.h:329-333), else the live params."""
        cw = self.optimizer.custom_weights(self.state["opt"], self.state["params"])
        return self.state["params"] if cw is None else cw

    def set_params(self, params) -> None:
        """Copy `params` into the fp32 master vector in place (a cached
        inference operand set sees the version bump and is rebuilt)."""
        params = torch.as_tensor(params, dtype=torch.float32)
        if params.shape != self.state["params"].shape:
            raise ValueError(
                f"expected {tuple(self.state['params'].shape)} params, "
                f"got {tuple(params.shape)}"
            )
        self.state["params"].copy_(params)

    # the reference's fp32 setter (trainer.h:242-269); the master params
    # are always fp32
    set_params_full_precision = set_params

    # ------------------------------------------------------------------
    # Training (trainer.py:183-254, 318-344)
    # ------------------------------------------------------------------
    def use_fused(self) -> bool:
        """The route of the next step: True for K6, False for autograd."""
        ok = (self.compute_dtype == COMPUTE_DTYPE
              and supported(self.model, self.loss_fn))
        if self.use_fused_train_kernel is True and not ok:
            raise ValueError(
                f"use_fused_train_kernel=True, but the fused train kernel does not take "
                f"{self.model!r} with {self.loss_fn!r}"
            )
        return ok and self.use_fused_train_kernel is not False

    def _noise(self, shape) -> torch.Tensor:
        """Logistic noise sigma * log(u / (1 - u)), u ~ U(1e-6, 1 - 1e-6)
        (trainer.h:114-121; trainer.py:195-199)."""
        u = torch.empty(shape, dtype=torch.float32, device=self.device)
        u.uniform_(1e-6, 1.0 - 1e-6, generator=self.noise_generator)
        return self.perturbation_sigma * torch.log(u / (1.0 - u))

    def loss_and_grad_fn(self, params, inputs, targets, pdf=None):
        """(loss sum, f32 gradient of the flat params); the gradient carries
        loss_scale (the optimizer divides it back out)."""
        if isinstance(targets, Rays):
            if pdf is not None or self.perturbation_sigma > 0 or self.use_fused():
                raise ValueError("rays train on the composed route, with no pdf or perturbation")
            return nerf.train_grads(self.model, self.loss_fn, params, inputs, targets,
                                    self.loss_scale, self.compute_dtype)
        noise = None
        if self.perturbation_sigma > 0:
            noise = self._noise((inputs.shape[0], self.model.padded_output_width))
        if self.use_fused():
            return fused_train_grads(self.model, self.loss_fn, params, inputs, targets,
                                     self.loss_scale, pdf=pdf, noise=noise)
        p = params.detach().requires_grad_(True)
        with torch.enable_grad():
            out = self.model.apply(p, inputs, compute_dtype=self.compute_dtype)
            if noise is not None:
                out = out + noise.to(out.dtype)
            total = self.loss_fn(out, targets, pdf).sum()
            (grads,) = torch.autograd.grad(self.loss_scale * total, p)
        return total.detach(), grads

    def external_grad_fn(self, params, inputs, dL_doutput):
        """f32 gradient of the flat params from a caller's dL/doutput
        [B, padded_output_width] (trainer.h:127-131): not multiplied by
        loss_scale, which the optimizer still divides out."""
        if self.use_fused():
            _, grads = fused_train_grads(self.model, self.loss_fn, params, inputs,
                                         dL_doutput.float().contiguous(), self.loss_scale,
                                         ext_dl=True)
            return grads
        p = params.detach().requires_grad_(True)
        with torch.enable_grad():
            out = self.model.apply(p, inputs, compute_dtype=self.compute_dtype)
            (grads,) = torch.autograd.grad(out, p, grad_outputs=dL_doutput.to(out.dtype))
        return grads

    def train_step_fn(self, state, inputs, targets, pdf=None, dL_doutput=None):
        """One step on `state` (updated in place); returns the loss sum."""
        if dL_doutput is not None:
            grads = self.external_grad_fn(state["params"], inputs, dL_doutput)
            loss_value = torch.zeros((), dtype=torch.float32, device=inputs.device)
        else:
            loss_value, grads = self.loss_and_grad_fn(state["params"], inputs, targets, pdf)
        with profiling.span("tcnn.optimizer.step"):
            self.optimizer.step(state["opt"], self.loss_scale, state["params"], grads)
        return loss_value

    def training_step(self, inputs, targets=None, pdf=None, dL_doutput=None):
        """Run one step; returns the loss as a 0-d device tensor (reading it
        synchronises, trainer.h:205-207). The span "tcnn.training_step"
        holds the step; its self time is the checks and the route gate."""
        with profiling.span("tcnn.training_step"):
            x = self._input(inputs)
            targets, pdf, dL_doutput = (None if t is None else self._input(t)
                                        for t in (targets, pdf, dL_doutput))
            if targets is None and dL_doutput is None:
                raise ValueError("training_step needs targets or dL_doutput")
            return self.train_step_fn(self.state, x, targets, pdf, dL_doutput)

    def _input(self, inputs) -> torch.Tensor:
        if isinstance(inputs, Rays):   # a ray loss's targets pass as they are
            return inputs
        x = torch.as_tensor(inputs, dtype=torch.float32)
        if x.device != self.device:
            raise ValueError(f"inputs on {x.device}, model on {self.device}")
        return x.contiguous()

    @torch.no_grad()
    def forward(self, inputs, targets=None, pdf=None, use_inference_params=False) -> dict:
        """Forward and loss values (trainer.h:97-141) through the composed
        `model.apply`, with the output perturbation a step would see."""
        params = self.inference_params if use_inference_params else self.params
        out = self.model.apply(params, self._input(inputs), compute_dtype=self.compute_dtype)
        if self.perturbation_sigma > 0:
            out = out + self._noise(out.shape).to(out.dtype)
        if targets is None:
            return {"output": out}
        pdf = None if pdf is None else self._input(pdf)
        return {"output": out, "loss_values": self.loss_fn(out, self._input(targets), pdf)}

    def loss(self, ctx) -> float:
        """Host float of the summed loss (trainer.h:205-207; synchronises)."""
        return float(ctx["loss_values"].sum())

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------
    def _prepared(self):
        """Prepared fused operands, cached on the tensors the inference
        params derive from, each by identity and version: the params and
        every optimizer-state leaf (tcnn_tpu/trainer.py:440-470). An
        in-place optimizer step, `set_params` or `load` bumps a version or
        swaps a tensor and rebuilds them; repeated calls between steps
        neither rebuild them nor recompute custom weights (EMA, Average and
        Lookahead return a fresh tensor each call). Span "tcnn.k3.operands";
        a rebuild counts "k3.operands_rebuilt"."""
        with profiling.span("tcnn.k3.operands"):
            srcs = [self.state["params"]] + tree_leaves(self.state["opt"])
            key = [(id(t), t._version) for t in srcs]
            cached = self._infer_prepared
            if cached is None or cached[0] != key:
                # the tensors stay referenced, so no id is reused while cached
                cached = (key, srcs, prepare_forward(self.model, self.inference_params))
                self._infer_prepared = cached
                profiling.count("k3.operands_rebuilt")
            return cached[2]

    @torch.no_grad()
    def inference(self, inputs) -> torch.Tensor:
        """fp32 output trimmed to n_output_dims (object.h:147-179). The span
        "tcnn.inference" holds the call; its self time is the checks, the
        route gate, and the output's slice and cast."""
        with profiling.span("tcnn.inference"):
            x = self._input(inputs)
            if self.compute_dtype == COMPUTE_DTYPE and supported_infer(self.model):
                y = fused_forward_prepared(self._prepared(), x)
            else:
                y = self.model.apply(self.inference_params, x, compute_dtype=self.compute_dtype)
            return y[:, : self.model.n_output_dims].float()

    # ------------------------------------------------------------------
    # Hyperparams / checkpointing (trainer.h:213-224, 275-315)
    # ------------------------------------------------------------------
    def update_hyperparams(self, params: dict) -> None:
        if "optimizer" in params:
            self.optimizer.update_hyperparams(params["optimizer"])
        if "loss" in params:
            self.loss_fn = create_loss(params["loss"])

    def serialize(self, serialize_optimizer: bool = True) -> dict:
        """JSON-compatible snapshot in `tcnn_tpu`'s format (trainer.h:275-288)."""
        data = {
            "n_params": int(self.model.n_params),
            "params_type": "float",
            "params_binary": array_to_json(self.params.cpu().numpy()),
        }
        if serialize_optimizer:
            data["optimizer"] = {
                "hyperparams": self.optimizer.hyperparams(),
                "state": tree_to_json(self.state["opt"]),
            }
        return data

    def deserialize(self, data: dict) -> None:
        """Restore from a snapshot written by this class or by `tcnn_tpu`'s
        `Trainer.serialize` (trainer.h:290-315): "float" and "__half"
        params, base64 arrays or raw little-endian byte lists, and the
        optimizer state when the snapshot has it."""
        ptype = data.get("params_type", "float")
        if ptype not in ("float", "__half"):
            raise ValueError("Trainer: snapshot parameters must be of type float or __half")
        blob = data["params_binary"]
        if isinstance(blob, dict) and "data" in blob:
            params = array_from_json(blob)
        elif isinstance(blob, (list, bytes, bytearray)):
            dt = np.float16 if ptype == "__half" else np.float32
            params = np.frombuffer(bytes(blob), dtype=dt)
        else:
            raise ValueError("unrecognized params_binary format")
        self.set_params(torch.from_numpy(np.asarray(params, np.float32).copy()))
        if data.get("optimizer") is not None:
            self.state["opt"] = tree_from_json(data["optimizer"]["state"], self.state["opt"])
            self.optimizer.load_state(self.state["opt"])

    def save(self, path: str, serialize_optimizer: bool = True) -> None:
        with open(path, "w") as f:
            json.dump(self.serialize(serialize_optimizer), f)

    def load(self, path: str) -> None:
        with open(path) as f:
            self.deserialize(json.load(f))
