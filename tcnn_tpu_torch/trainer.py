"""Trainer: owns the model's flat fp32 params and runs inference.

Counterpart of ``tcnn_tpu/trainer.py`` (the reference's Trainer,
trainer.h:47-361) for the part the port has so far: params, forward,
inference and the JSON checkpoint. Training comes with the port of the loss
and Adam; until then the loss and optimizer are kept as their config dicts.

Inference follows the JAX package's dispatch (trainer.py:418-479) with no
silent route: a grid + FullyFusedMLP model without Sine and without a
max_level clamp runs the fused kernel K3 (its plain twin on the CPU); every
other model runs `model.apply` (K1, then K2 or the matmul chain). The JAX
gate's VMEM estimate has no counterpart: K3's wrapper checks the shared
memory its tile and weights really need and raises when no tile fits.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .ops.cuda.train_kernel import (
    fused_forward_prepared,
    fused_plan_for,
    prepare_forward,
)
from .utils.serialization import array_from_json, array_to_json


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
    def __init__(self, model, optimizer: dict, loss: dict, seed: int = 1337, device="cpu"):
        self.model = model
        #: optimizer and loss config blocks, kept for their port
        self.optimizer = optimizer
        self.loss = loss
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        self.state = {"params": model.init_params(gen).to(self.device)}
        self._infer_prepared = None

    @property
    def params(self) -> torch.Tensor:
        return self.state["params"]

    @property
    def inference_params(self) -> torch.Tensor:
        """The live params (custom-weights optimizers come with the
        optimizer port, trainer.h:329-333)."""
        return self.state["params"]

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

    def training_step(self, inputs, targets=None, pdf=None, dL_doutput=None):
        raise NotImplementedError(
            "training is not ported to tcnn_tpu_torch yet: it comes with the "
            "port of the loss and Adam and the backward kernels (ROADMAP "
            "Queue A item 4)"
        )

    def _input(self, inputs) -> torch.Tensor:
        x = torch.as_tensor(inputs, dtype=torch.float32)
        if x.device != self.device:
            raise ValueError(f"inputs on {x.device}, model on {self.device}")
        return x.contiguous()

    @torch.no_grad()
    def forward(self, inputs) -> dict:
        """Forward without loss (the loss comes with its port): the padded
        bf16 network output of the composed `model.apply`."""
        return {"output": self.model.apply(self.params, self._input(inputs))}

    def _prepared(self):
        """Prepared fused operands, cached on the params tensor's identity
        and version, so an in-place `set_params` or `load` invalidates them."""
        p = self.inference_params
        cached = self._infer_prepared
        if cached is None or cached[0] is not p or cached[1] != p._version:
            cached = (p, p._version, prepare_forward(self.model, p))
            self._infer_prepared = cached
        return cached[2]

    @torch.no_grad()
    def inference(self, inputs) -> torch.Tensor:
        """fp32 output trimmed to n_output_dims (object.h:147-179)."""
        x = self._input(inputs)
        enc = getattr(self.model, "encoding", None)
        if fused_plan_for(self.model) is not None and enc.max_level is None:
            y = fused_forward_prepared(self._prepared(), x)
        else:
            y = self.model.apply(self.inference_params, x)
        return y[:, : self.model.n_output_dims].float()

    # ------------------------------------------------------------------
    # Checkpointing (trainer.h:275-315)
    # ------------------------------------------------------------------
    def serialize(self) -> dict:
        """JSON-compatible snapshot of the params (trainer.h:275-288)."""
        return {
            "n_params": int(self.model.n_params),
            "params_type": "float",
            "params_binary": array_to_json(self.params.cpu().numpy()),
        }

    def deserialize(self, data: dict) -> None:
        """Restore the params from a snapshot written by this class or by
        `tcnn_tpu`'s `Trainer.serialize` (trainer.h:290-315): "float" and
        "__half" snapshots, base64 arrays or raw little-endian byte lists.
        The snapshot's optimizer block is left for the optimizer port."""
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

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.serialize(), f)

    def load(self, path: str) -> None:
        with open(path) as f:
            self.deserialize(json.load(f))
