"""Network protocol (counterpart of ``tcnn_tpu/models/base.py``)."""

from __future__ import annotations

import abc

import torch

from ..common import OUTPUT_WIDTH_ALIGNMENT, next_multiple


class Network(abc.ABC):
    """A parametric map [B, input_width] -> [B, padded_output_width].

    Parameters live in a flat fp32 vector (the reference's single param
    buffer, trainer.h:75) held by the caller; `apply` slices it. The real
    output occupies the first `n_output_dims` columns; the rest is padding
    the consumer trims (object.h:175).
    """

    #: alignment the network demands of its input width (network.cu:76-95)
    minimum_alignment: int = OUTPUT_WIDTH_ALIGNMENT

    def __init__(self, input_width: int, n_output_dims: int):
        self.input_width = int(input_width)
        self.n_output_dims = int(n_output_dims)

    @property
    def padded_output_width(self) -> int:
        return next_multiple(self.n_output_dims, OUTPUT_WIDTH_ALIGNMENT)

    @property
    @abc.abstractmethod
    def n_params(self) -> int:
        ...

    @abc.abstractmethod
    def layer_sizes(self):
        """[(rows, cols)] of every weight matrix (object.h:97)."""

    @abc.abstractmethod
    def init_params(self, generator: torch.Generator) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def apply(self, params, x):
        ...

    @abc.abstractmethod
    def hyperparams(self) -> dict:
        ...

    def update_hyperparams(self, params: dict) -> None:
        pass

    def __repr__(self):
        return f"{type(self).__name__}({self.hyperparams()})"
