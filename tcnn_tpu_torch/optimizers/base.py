"""Optimizer protocol (counterpart of ``tcnn_tpu/optimizers/base.py``; the
reference's Optimizer<T>, optimizer.h:39-63).

  - `allocate(n_weights, layer_sizes)` fixes the sizes. `layer_sizes` lists
    (rows, cols) of the *matrix* (network) params, which occupy the first
    sum(r*c) entries of the flat vector; everything after is non-matrix
    (encoding tables), which drives Adam's matrix-only L2 (adam.h:88-91).
  - `init_state(device)` returns the state as a dict of tensors, on the
    card unless the caller passes `device="cpu"` (like every entry point).
  - `step(state, loss_scale, weights, grads)` updates `state` and the flat
    fp32 `weights` in place (the JAX package returns new arrays; updating in
    place keeps one copy of each on the card). `grads` are fp32 and still
    carry loss_scale, which the optimizer divides out (adam.h:75).
  - `custom_weights(state, weights)` returns averaged weights for inference
    (optimizer.h:53), or None.
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

    @abc.abstractmethod
    def init_state(self, device="cuda") -> dict:
        ...

    @abc.abstractmethod
    def step(self, state: dict, loss_scale: float, weights, grads) -> None:
        """Update `state` and `weights` in place."""

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
