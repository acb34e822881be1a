"""Optimizer protocol (counterpart of ``tcnn_tpu/optimizers/base.py``; the
reference's Optimizer<T>, optimizer.h:39-63).

  - `allocate(n_weights, layer_sizes)` fixes the sizes. `layer_sizes` lists
    (rows, cols) of the *matrix* (network) params, which occupy the first
    sum(r*c) entries of the flat vector; everything after is non-matrix
    (encoding tables), which drives Adam's matrix-only L2 (adam.h:88-91).
  - `init_state(device)` returns the state as a dict of tensors, on the
    card unless the caller passes `device="cpu"` (like every entry point).
  - `step(state, loss_scale, weights, grads, lr_scale=1.0)` updates `state`
    and the flat fp32 `weights` in place (the JAX package returns new
    arrays; updating in place keeps one copy of each on the card, and lets
    Composite hand each nested optimizer a view of its segment). `grads` are
    fp32 and still carry loss_scale, which the optimizer divides out
    (adam.h:75). `lr_scale` multiplies the learning rate: a float, or a 0-d
    f32 tensor on the weights' device (ExponentialDecay's factor), so that
    no step reads the device.
  - `custom_weights(state, weights)` returns averaged weights for inference
    (optimizer.h:53), or None.

An optimizer whose work depends on its step count (Average's ring slot,
Lookahead's and Batched's every-N steps, Shampoo's root refresh) keeps that
count on the host as well: `init_state` sets it to 0, each `step` adds one,
and `load_state` re-reads it from a state that replaced the one it drove
(a snapshot load, one device read). One optimizer drives one state.
"""

from __future__ import annotations

import abc


class Optimizer(abc.ABC):
    def __init__(self):
        self._n_weights = 0
        self._layer_sizes = []

    def allocate(self, n_weights: int, layer_sizes) -> None:
        self._n_weights = int(n_weights)
        self._layer_sizes = [(int(r), int(c)) for r, c in layer_sizes]

    @property
    def n_weights(self) -> int:
        return self._n_weights

    @property
    def n_matrix_weights(self) -> int:
        return sum(r * c for r, c in self._layer_sizes)

    @property
    def layer_sizes(self):
        return list(self._layer_sizes)

    #: Composite's partition (optimizers/composite.h:46-91); None means "all
    #: remaining params".
    n_params_to_optimize: int | None = None

    @abc.abstractmethod
    def init_state(self, device="cuda") -> dict:
        ...

    @abc.abstractmethod
    def step(self, state: dict, loss_scale: float, weights, grads, lr_scale=1.0) -> None:
        """Update `state` and `weights` in place."""

    def load_state(self, state: dict) -> None:
        """Re-read the host-side step counts of `state`, which replaced the
        state this optimizer drove (none to read here)."""

    def custom_weights(self, state, weights=None):
        """Averaged/slow weights for inference, or None."""
        return None

    @property
    @abc.abstractmethod
    def learning_rate(self) -> float:
        ...

    @abc.abstractmethod
    def set_learning_rate(self, lr: float) -> None:
        ...

    @abc.abstractmethod
    def hyperparams(self) -> dict:
        ...

    @abc.abstractmethod
    def update_hyperparams(self, params: dict) -> None:
        ...

    def __repr__(self):
        return f"{type(self).__name__}({self.hyperparams()})"
