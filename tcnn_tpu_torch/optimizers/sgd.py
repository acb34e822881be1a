"""Plain SGD with L2 (counterpart of ``tcnn_tpu/optimizers/sgd.py``; the
reference's optimizers/sgd.h:45-70): w -= lr * (g / loss_scale + l2 * w),
elementwise torch on the flat vector, in place."""

from __future__ import annotations

import torch

from .base import Optimizer


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate: float = 1e-3, l2_reg: float = 1e-8):
        super().__init__()
        self.base_learning_rate = float(learning_rate)
        self.l2_reg = float(l2_reg)

    def init_state(self, device="cuda") -> dict:
        return {"step": torch.zeros((), dtype=torch.int64, device=device)}

    def step(self, state, loss_scale, weights, grads, lr_scale=1.0) -> None:
        g = grads.float() / loss_scale + self.l2_reg * weights
        weights.copy_(weights - (self.base_learning_rate * lr_scale) * g)
        state["step"].add_(1)

    @property
    def learning_rate(self) -> float:
        return self.base_learning_rate

    def set_learning_rate(self, lr: float) -> None:
        self.base_learning_rate = float(lr)

    def hyperparams(self) -> dict:
        return {"otype": "SGD", "learning_rate": self.base_learning_rate, "l2_reg": self.l2_reg}

    def update_hyperparams(self, params: dict) -> None:
        if "learning_rate" in params:
            self.base_learning_rate = params["learning_rate"]
        if "l2_reg" in params:
            self.l2_reg = params["l2_reg"]
