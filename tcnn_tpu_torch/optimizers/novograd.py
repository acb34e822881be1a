"""Novograd (counterpart of ``tcnn_tpu/optimizers/novograd.py``; the
reference's optimizers/novograd.h:45-140).

One second moment per *matrix layer*,
    v_l = beta2 * v_l + (1 - beta2) * ||g_l||^2 / loss_scale^2
(the norm of the scaled gradient, then divided), first moments per
parameter,
    m_i = beta1 * m_i + (1 - beta1) * g_i / (sqrt(v_layer(i)) + eps)
and the update w_i = weight_decay(rel*lr, abs*lr, w_i) - lr * m_i. Only the
parameters `layer_sizes` covers are updated; the non-matrix remainder
(encoding tables) stays as it is, as the reference's loop over m_layers
leaves it. Each layer's norm is a reduction over its slice, so the step
needs no index tensor on the device.
"""

from __future__ import annotations

import torch

from .base import Optimizer


class NovogradOptimizer(Optimizer):
    def __init__(
        self,
        learning_rate: float = 1e-3,
        beta1: float = 0.9,
        beta2: float = 0.999,
        epsilon: float = 1e-8,
        relative_decay: float = 0.0,
        absolute_decay: float = 0.0,
    ):
        super().__init__()
        self.base_learning_rate = float(learning_rate)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.epsilon = float(epsilon)
        self.relative_decay = float(relative_decay)
        self.absolute_decay = float(absolute_decay)

    def init_state(self, device="cuda") -> dict:
        return {
            "first_moments": torch.zeros(self.n_matrix_weights, dtype=torch.float32,
                                         device=device),
            "per_layer_second_moment": torch.zeros(len(self.layer_sizes), dtype=torch.float32,
                                                   device=device),
            "step": torch.zeros((), dtype=torch.int64, device=device),
        }

    def step(self, state, loss_scale, weights, grads, lr_scale=1.0) -> None:
        sizes = [r * c for r, c in self.layer_sizes]
        n_matrix = sum(sizes)
        state["step"].add_(1)
        if not sizes:
            return
        g = grads[:n_matrix].float()
        w = weights[:n_matrix]
        norms = torch.stack([(part * part).sum() for part in g.split(sizes)])
        v = self.beta2 * state["per_layer_second_moment"] + (1 - self.beta2) * norms / (
            loss_scale * loss_scale)
        denom = torch.cat([s.expand(n) for s, n in zip(torch.sqrt(v).unbind(), sizes)])
        m = self.beta1 * state["first_moments"] + (1 - self.beta1) * (
            g / loss_scale / (denom + self.epsilon))
        lr = self.base_learning_rate * lr_scale
        decayed = (1 - self.relative_decay * lr) * w - torch.copysign(
            self.absolute_decay * lr * torch.ones_like(w), w)
        w.copy_(decayed - lr * m)
        state["first_moments"].copy_(m)
        state["per_layer_second_moment"].copy_(v)

    @property
    def learning_rate(self) -> float:
        return self.base_learning_rate

    def set_learning_rate(self, lr: float) -> None:
        self.base_learning_rate = float(lr)

    def hyperparams(self) -> dict:
        return {
            "otype": "Novograd",
            "learning_rate": self.base_learning_rate,
            "beta1": self.beta1,
            "beta2": self.beta2,
            "epsilon": self.epsilon,
            "relative_decay": self.relative_decay,
            "absolute_decay": self.absolute_decay,
        }

    def update_hyperparams(self, params: dict) -> None:
        for key, attr in [
            ("learning_rate", "base_learning_rate"),
            ("beta1", "beta1"),
            ("beta2", "beta2"),
            ("epsilon", "epsilon"),
            ("relative_decay", "relative_decay"),
            ("absolute_decay", "absolute_decay"),
        ]:
            if key in params:
                setattr(self, attr, params[key])
