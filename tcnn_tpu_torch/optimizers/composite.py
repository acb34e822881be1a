"""Composite optimizer: the flat param vector in segments, one nested
optimizer each (counterpart of ``tcnn_tpu/optimizers/composite.py``; the
reference's optimizers/composite.h:43-140).

Nested optimizer i covers [offset_i, offset_i + n_i), n_i its config's
`n_params_to_optimize`; the last may leave it out and take the remainder,
as in the JAX package. Each gets a *view* of its segment of the weights and
the gradient and updates it in place. `layer_sizes` are sliced per segment:
a layer wholly inside passes through, a layer cut by the boundary gives its
overlap as an (n_overlap, 1) pseudo-layer (slice_weights,
composite.h:30-41).
"""

from __future__ import annotations

import torch

from .base import Optimizer


def _slice_layer_sizes(layer_sizes, offset, size):
    out = []
    pos = 0
    lo, hi = offset, offset + size
    for r, c in layer_sizes:
        n = r * c
        a, b = max(pos, lo), min(pos + n, hi)
        if b > a:
            out.append((r, c) if (a, b) == (pos, pos + n) else (b - a, 1))
        pos += n
    return out


class CompositeOptimizer(Optimizer):
    otype = "Composite"

    def __init__(self, nested, n_params_per_nested):
        """`n_params_per_nested[i]` may be None only for the last entry."""
        super().__init__()
        self.nested = list(nested)
        self._declared = list(n_params_per_nested)

    def allocate(self, n_weights, layer_sizes):
        super().allocate(n_weights, layer_sizes)
        offsets = [0]
        for i, n in enumerate(self._declared):
            if n is None:
                if i != len(self._declared) - 1:
                    raise ValueError("only the last nested optimizer may omit n_params_to_optimize")
                n = n_weights - offsets[-1]
            offsets.append(offsets[-1] + int(n))
        if offsets[-1] != n_weights:
            raise ValueError(
                f"Composite optimizer covers {offsets[-1]} params, model has {n_weights}")
        self._offsets = offsets
        for i, opt in enumerate(self.nested):
            size = offsets[i + 1] - offsets[i]
            opt.allocate(size, _slice_layer_sizes(layer_sizes, offsets[i], size))

    def _segments(self):
        return [slice(lo, hi) for lo, hi in zip(self._offsets, self._offsets[1:])]

    def init_state(self, device="cuda") -> dict:
        return {"nested": [opt.init_state(device) for opt in self.nested]}

    def step(self, state, loss_scale, weights, grads, lr_scale=1.0) -> None:
        for opt, s, seg in zip(self.nested, state["nested"], self._segments()):
            opt.step(s, loss_scale, weights[seg], grads[seg], lr_scale)

    def load_state(self, state) -> None:
        for opt, s in zip(self.nested, state["nested"]):
            opt.load_state(s)

    def custom_weights(self, state, weights=None):
        """composite.h:79-88: the nested custom weights stitched, the live
        weights where a segment has none; None when no segment has any."""
        parts = []
        for opt, s, seg in zip(self.nested, state["nested"], self._segments()):
            wseg = None if weights is None else weights[seg]
            parts.append((opt.custom_weights(s, wseg), wseg))
        if all(cw is None for cw, _ in parts):
            return None
        return torch.cat([wseg if cw is None else cw for cw, wseg in parts])

    @property
    def learning_rate(self) -> float:
        return self.nested[0].learning_rate

    def set_learning_rate(self, lr: float) -> None:
        for opt in self.nested:
            opt.set_learning_rate(lr)

    def hyperparams(self):
        return {"otype": "Composite", "nested": [opt.hyperparams() for opt in self.nested]}

    def update_hyperparams(self, params: dict) -> None:
        if "nested" in params:
            for opt, p in zip(self.nested, params["nested"]):
                opt.update_hyperparams(p)
