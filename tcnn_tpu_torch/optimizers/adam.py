"""Adam (generalised to AdaBound) with tcnn-exact semantics: counterpart of
``tcnn_tpu/optimizers/adam.py:27-166`` (the reference's adam_step,
optimizers/adam.h:47-188).

  - lazy per-parameter step counters: a non-matrix parameter whose gradient
    is exactly zero this step is skipped (no moment decay, no step count, no
    decay; adam.h:77-84), which leaves untouched hash-table rows alone;
  - L2 regularisation on matrix (network) weights only (adam.h:88-91);
  - debiasing from the per-parameter step counts (adam.h:103-105);
  - AdaBound's bounds from the global step (adam.h:156-165);
  - relative/absolute weight decay scaled by the debiased lr (adam.h:110);
  - optional weight clipping, a separate non-matrix lr factor, and matrix /
    non-matrix enable flags.

The JAX package runs this as one XLA computation, not a Pallas kernel. The
port runs it in place on the flat vector: on a CUDA tensor as one kernel,
K14 (``ops/cuda/adam_kernel.py``, ``csrc/adam.cu``), on a CPU tensor as
its plain elementwise twin, `_step_plain`. `param_steps` and `step` are
int64 on the device (uint32 in the JAX package and in snapshots,
utils/serialization.py).
"""

from __future__ import annotations

import torch

from ..ops.cuda import adam_kernel
from .base import Optimizer


class AdamOptimizer(Optimizer):
    def __init__(
        self,
        learning_rate: float = 1e-3,
        beta1: float = 0.9,
        beta2: float = 0.999,
        epsilon: float = 1e-8,
        l2_reg: float = 1e-8,
        relative_decay: float = 0.0,
        absolute_decay: float = 0.0,
        adabound: bool = False,
        clipping_magnitude: float = 0.0,
        non_matrix_learning_rate_factor: float = 1.0,
        optimize_matrix_params: bool = True,
        optimize_non_matrix_params: bool = True,
    ):
        super().__init__()
        self.base_learning_rate = float(learning_rate)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.epsilon = float(epsilon)
        self.l2_reg = float(l2_reg)
        self.relative_decay = float(relative_decay)
        self.absolute_decay = float(absolute_decay)
        self.adabound = bool(adabound)
        self.clipping_magnitude = float(clipping_magnitude)
        self.non_matrix_learning_rate_factor = float(non_matrix_learning_rate_factor)
        self.optimize_matrix_params = bool(optimize_matrix_params)
        self.optimize_non_matrix_params = bool(optimize_non_matrix_params)

    def init_state(self, device="cuda") -> dict:
        n = self.n_weights
        return {
            "first_moments": torch.zeros(n, dtype=torch.float32, device=device),
            "second_moments": torch.zeros(n, dtype=torch.float32, device=device),
            "param_steps": torch.zeros(n, dtype=torch.int64, device=device),
            "step": torch.zeros((), dtype=torch.int64, device=device),
        }

    def step(self, state, loss_scale, weights, grads, lr_scale=1.0) -> None:
        if weights.device.type == "cpu":
            self._step_plain(state, loss_scale, weights, grads, lr_scale)
        else:
            adam_kernel.adam_step(self, state, loss_scale, weights, grads, lr_scale)

    def _step_plain(self, state, loss_scale, weights, grads, lr_scale=1.0) -> None:
        """K14's plain twin: the step in elementwise torch, on any device."""
        is_matrix = torch.arange(self.n_weights, device=weights.device) < self.n_matrix_weights
        g = grads.float() / loss_scale

        # skip rule (adam.h:76-84)
        if self.optimize_non_matrix_params:
            non_matrix_active = g != 0.0
        else:
            non_matrix_active = torch.zeros_like(is_matrix)
        active = torch.where(is_matrix, self.optimize_matrix_params, non_matrix_active)

        g = torch.where(is_matrix, g + self.l2_reg * weights, g)
        m1 = self.beta1 * state["first_moments"] + (1 - self.beta1) * g
        m2 = self.beta2 * state["second_moments"] + (1 - self.beta2) * g * g

        state["step"].add_(1)
        state["param_steps"].add_(active)
        t = state["param_steps"].float()

        base_lr = self.base_learning_rate * lr_scale
        lr = torch.where(is_matrix, base_lr, base_lr * self.non_matrix_learning_rate_factor)
        lr = lr * torch.sqrt(1 - self.beta2**t) / (1 - self.beta1**t)

        if self.adabound:
            # adam.h:156-165: bounds from the global step
            gs = state["step"].float()
            lower = 0.1 - 0.1 / ((1 - self.beta2) * gs + 1)
            upper = 0.1 + 0.1 / ((1 - self.beta2) * gs)
        else:
            lower, upper = 0.0, torch.finfo(torch.float32).max
        eff_lr = torch.clamp(lr / (torch.sqrt(m2) + self.epsilon), lower, upper)

        # weight_decay(rel*lr, abs*lr, w) (common_device.h:869-872)
        decayed = (1 - self.relative_decay * lr) * weights - torch.copysign(
            self.absolute_decay * lr, weights
        )
        new_w = decayed - eff_lr * m1
        if self.clipping_magnitude != 0.0:
            new_w = torch.clamp(new_w, -self.clipping_magnitude, self.clipping_magnitude)

        state["first_moments"].copy_(torch.where(active, m1, state["first_moments"]))
        state["second_moments"].copy_(torch.where(active, m2, state["second_moments"]))
        weights.copy_(torch.where(active, new_w, weights))

    @property
    def learning_rate(self) -> float:
        return self.base_learning_rate

    def set_learning_rate(self, lr: float) -> None:
        self.base_learning_rate = float(lr)

    def hyperparams(self) -> dict:
        return {
            "otype": "Adam",
            "beta1": self.beta1,
            "beta2": self.beta2,
            "epsilon": self.epsilon,
            "learning_rate": self.base_learning_rate,
            "l2_reg": self.l2_reg,
            "adabound": self.adabound,
            "relative_decay": self.relative_decay,
            "absolute_decay": self.absolute_decay,
            "clipping_magnitude": self.clipping_magnitude,
            "non_matrix_learning_rate_factor": self.non_matrix_learning_rate_factor,
            "optimize_matrix_params": self.optimize_matrix_params,
            "optimize_non_matrix_params": self.optimize_non_matrix_params,
        }

    def update_hyperparams(self, params: dict) -> None:
        for key, attr in [
            ("beta1", "beta1"),
            ("beta2", "beta2"),
            ("epsilon", "epsilon"),
            ("learning_rate", "base_learning_rate"),
            ("l2_reg", "l2_reg"),
            ("adabound", "adabound"),
            ("relative_decay", "relative_decay"),
            ("absolute_decay", "absolute_decay"),
            ("clipping_magnitude", "clipping_magnitude"),
            ("non_matrix_learning_rate_factor", "non_matrix_learning_rate_factor"),
            ("optimize_matrix_params", "optimize_matrix_params"),
            ("optimize_non_matrix_params", "optimize_non_matrix_params"),
        ]:
            if key in params:
                setattr(self, attr, params[key])
