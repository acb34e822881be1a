"""Wrapper optimizers: EMA, Average, Lookahead, Batched, ExponentialDecay
(counterpart of ``tcnn_tpu/optimizers/wrappers.py``). Each wraps a nested
optimizer, keeps its state under "nested" and adds its own leaves; every
step runs in place on the flat vector, as the nested optimizer's does.

Reference semantics (the reference's optimizers/*.h):
  - EMA (ema.h:45-120): after the nested step, raw_t = decay * raw_{t-1} +
    (1 - decay) * w_t, and custom_weights = raw_t / (1 - decay^t). If the
    nested optimizer has custom weights, the EMA filters those instead.
  - Average (average.h:45-120): a ring buffer of the last n_samples
    weights; average += (w - buffer[t % N]) / N; buffer[t % N] = w.
  - Lookahead (lookahead.h:45-115): BEFORE the nested step, when
    t % n_steps == 0: w = slow * (1 - alpha) + w * alpha; slow = w (slow
    starts as w at step 0).
  - Batched (batched.h:45-110): pool = 0 at the start of each window;
    pool += g / N each step; a nested step on the pool every N steps.
  - ExponentialDecay (exponential_decay.h:46-110): multiplies the nested lr
    by decay_base whenever step >= decay_start, step <= decay_end and
    (step - decay_start) % decay_interval == 0, with the nested optimizer's
    step count before its step.

No step reads the device. Average, Lookahead and Batched decide on their
host-side step count (optimizers/base.py), where the JAX package selects
with jnp.where or skips with lax.cond: Batched skips the nested step off
its window's end, as lax.cond does. ExponentialDecay's factor stays a 0-d
device tensor ("lr_factor") and reaches the nested optimizer as `lr_scale`,
as the JAX package threads its traced factor.
"""

from __future__ import annotations

import torch

from .base import Optimizer


class _WrapperOptimizer(Optimizer):
    otype = "Wrapper"

    def __init__(self, nested: Optimizer):
        super().__init__()
        self.nested = nested

    def allocate(self, n_weights, layer_sizes):
        super().allocate(n_weights, layer_sizes)
        self.nested.allocate(n_weights, layer_sizes)

    @property
    def learning_rate(self) -> float:
        return self.nested.learning_rate

    def set_learning_rate(self, lr: float) -> None:
        self.nested.set_learning_rate(lr)

    def custom_weights(self, state, weights=None):
        return self.nested.custom_weights(state["nested"], weights)

    def load_state(self, state) -> None:
        self.nested.load_state(state["nested"])

    def update_hyperparams(self, params: dict) -> None:
        if "nested" in params:
            self.nested.update_hyperparams(params["nested"])

    def _zeros(self, shape, device, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)


class _HostStepped(_WrapperOptimizer):
    """A wrapper that decides on its step count, kept on the host too."""

    def _init(self, device, **leaves) -> dict:
        self._host_step = 0
        return {"nested": self.nested.init_state(device), **leaves,
                "step": torch.zeros((), dtype=torch.int64, device=device)}

    def _advance(self, state) -> None:
        state["step"].add_(1)
        self._host_step += 1

    def load_state(self, state) -> None:
        self._host_step = int(state["step"])
        super().load_state(state)


class EmaOptimizer(_WrapperOptimizer):
    otype = "EMA"

    def __init__(self, nested: Optimizer, decay: float = 0.99):
        super().__init__(nested)
        self.decay = float(decay)

    def init_state(self, device="cuda") -> dict:
        return {
            "nested": self.nested.init_state(device),
            "ema": self._zeros(self.n_weights, device),
            "step": self._zeros((), device, torch.int64),
        }

    def step(self, state, loss_scale, weights, grads, lr_scale=1.0) -> None:
        self.nested.step(state["nested"], loss_scale, weights, grads, lr_scale)
        src = self.nested.custom_weights(state["nested"], weights)
        if src is None:
            src = weights
        state["ema"].copy_(self.decay * state["ema"] + (1 - self.decay) * src)
        state["step"].add_(1)

    def custom_weights(self, state, weights=None):
        debias = 1.0 / (1.0 - self.decay ** state["step"].float())
        return state["ema"] * torch.where(torch.isfinite(debias), debias, 0.0)

    def hyperparams(self):
        return {"otype": "EMA", "decay": self.decay, "nested": self.nested.hyperparams()}

    def update_hyperparams(self, params: dict) -> None:
        if "decay" in params:
            self.decay = params["decay"]
        super().update_hyperparams(params)


class AverageOptimizer(_HostStepped):
    otype = "Average"

    def __init__(self, nested: Optimizer, n_samples: int = 128):
        super().__init__(nested)
        self.n_samples = int(n_samples)

    def init_state(self, device="cuda") -> dict:
        return self._init(device, samples=self._zeros((self.n_samples, self.n_weights), device),
                          average=self._zeros(self.n_weights, device))

    def step(self, state, loss_scale, weights, grads, lr_scale=1.0) -> None:
        self.nested.step(state["nested"], loss_scale, weights, grads, lr_scale)
        slot = state["samples"][self._host_step % self.n_samples]
        state["average"].copy_(state["average"] + (weights - slot) / self.n_samples)
        slot.copy_(weights)
        self._advance(state)

    def custom_weights(self, state, weights=None):
        return state["average"]

    def hyperparams(self):
        return {"otype": "Average", "n_samples": self.n_samples,
                "nested": self.nested.hyperparams()}

    def update_hyperparams(self, params: dict) -> None:
        if "n_samples" in params:
            self.n_samples = int(params["n_samples"])
        super().update_hyperparams(params)


class LookaheadOptimizer(_HostStepped):
    otype = "Lookahead"

    def __init__(self, nested: Optimizer, alpha: float = 0.5, n_steps: int = 16):
        super().__init__(nested)
        self.alpha = float(alpha)
        self.n_steps = int(n_steps)

    def init_state(self, device="cuda") -> dict:
        return self._init(device, slow=self._zeros(self.n_weights, device))

    def step(self, state, loss_scale, weights, grads, lr_scale=1.0) -> None:
        t = self._host_step
        slow = state["slow"]
        if t == 0:
            slow.copy_(weights)
        if t % self.n_steps == 0:
            slow.copy_(slow * (1.0 - self.alpha) + weights * self.alpha)
            weights.copy_(slow)
        self.nested.step(state["nested"], loss_scale, weights, grads, lr_scale)
        self._advance(state)

    def custom_weights(self, state, weights=None):
        return state["slow"]

    def hyperparams(self):
        return {"otype": "Lookahead", "alpha": self.alpha, "n_steps": self.n_steps,
                "nested": self.nested.hyperparams()}

    def update_hyperparams(self, params: dict) -> None:
        if "alpha" in params:
            self.alpha = params["alpha"]
        if "n_steps" in params:
            self.n_steps = int(params["n_steps"])
        super().update_hyperparams(params)


class BatchedOptimizer(_HostStepped):
    otype = "Batched"

    def __init__(self, nested: Optimizer, batch_size_multiplier: int = 16):
        super().__init__(nested)
        self.batch_size_multiplier = int(batch_size_multiplier)

    def init_state(self, device="cuda") -> dict:
        return self._init(device, pool=self._zeros(self.n_weights, device))

    def step(self, state, loss_scale, weights, grads, lr_scale=1.0) -> None:
        n = self.batch_size_multiplier
        pool = state["pool"]
        if self._host_step % n == 0:
            pool.zero_()
        pool.add_(grads.float() / n)
        self._advance(state)
        if self._host_step % n == 0:
            self.nested.step(state["nested"], loss_scale, weights, pool, lr_scale)

    def hyperparams(self):
        return {"otype": "Batched", "batch_size_multiplier": self.batch_size_multiplier,
                "nested": self.nested.hyperparams()}

    def update_hyperparams(self, params: dict) -> None:
        if "batch_size_multiplier" in params:
            self.batch_size_multiplier = int(params["batch_size_multiplier"])
        super().update_hyperparams(params)


class ExponentialDecayOptimizer(_WrapperOptimizer):
    otype = "ExponentialDecay"

    def __init__(self, nested: Optimizer, decay_base: float = 0.1, decay_start: int = 10000,
                 decay_end: int = 10000000, decay_interval: int = 10000):
        super().__init__(nested)
        self.decay_base = float(decay_base)
        self.decay_start = int(decay_start)
        self.decay_end = int(decay_end)
        self.decay_interval = int(decay_interval)

    def init_state(self, device="cuda") -> dict:
        return {"nested": self.nested.init_state(device),
                "lr_factor": torch.ones((), dtype=torch.float32, device=device)}

    def step(self, state, loss_scale, weights, grads, lr_scale=1.0) -> None:
        t = _nested_step_count(state["nested"], state["lr_factor"].device)
        decay_now = ((t >= self.decay_start) & (t <= self.decay_end)
                     & ((t - self.decay_start) % self.decay_interval == 0))
        factor = state["lr_factor"] * torch.where(decay_now, self.decay_base, 1.0)
        self.nested.step(state["nested"], loss_scale, weights, grads, lr_scale * factor)
        state["lr_factor"].copy_(factor)

    def hyperparams(self):
        return {
            "otype": "ExponentialDecay",
            "decay_base": self.decay_base,
            "decay_start": self.decay_start,
            "decay_end": self.decay_end,
            "decay_interval": self.decay_interval,
            "nested": self.nested.hyperparams(),
        }

    def update_hyperparams(self, params: dict) -> None:
        for k in ("decay_base", "decay_start", "decay_end", "decay_interval"):
            if k in params:
                setattr(self, k, params[k])
        super().update_hyperparams(params)


def _nested_step_count(nested_state, device):
    """The innermost "step" counter of a nested state (a 0-d device tensor,
    read before the nested step), or 0."""
    s = nested_state
    while isinstance(s, dict) and "step" not in s and "nested" in s:
        s = s["nested"]
    if isinstance(s, dict) and "step" in s:
        return s["step"]
    return torch.zeros((), dtype=torch.int64, device=device)
