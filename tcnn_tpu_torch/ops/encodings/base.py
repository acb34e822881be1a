"""Encoding protocol.

Counterpart of ``tcnn_tpu/ops/encodings/base.py``: every encoding consumes
`n_dims_to_encode` input dims and produces `n_output_dims` real outputs,
padded up to `padded_output_width` with a constant (0 for parametric grids,
grid.h:749-759; 1 for fixed-function encodings, frequency.h:64-65). Its
parameters, if any, live in one flat fp32 vector slice. The output is in
`compute_dtype`: bf16 by default, f32 where the caller asks for it.
"""

from __future__ import annotations

import abc

import torch
import torch.nn.functional as F

from ...common import COMPUTE_DTYPE, next_multiple


class Encoding(abc.ABC):
    """Base class for all input encodings."""

    #: value used for padding columns (overridden per subclass)
    pad_value: float = 1.0

    def __init__(self, n_dims_to_encode: int):
        self.n_dims_to_encode = int(n_dims_to_encode)
        self._alignment = 1
        self._explicit_padded_width: int | None = None

    # -- shape contract ----------------------------------------------------
    @property
    @abc.abstractmethod
    def n_output_dims(self) -> int:
        ...

    @property
    def padded_output_width(self) -> int:
        if self._explicit_padded_width is not None:
            return self._explicit_padded_width
        return next_multiple(self.n_output_dims, self._alignment)

    @property
    def n_to_pad(self) -> int:
        return self.padded_output_width - self.n_output_dims

    def set_alignment(self, alignment: int) -> None:
        """Pad output width to a multiple of `alignment` (encoding.h:53-72)."""
        self._alignment = max(1, int(alignment))
        self._explicit_padded_width = None

    def set_padded_output_width(self, width: int) -> None:
        """Pad output width to exactly `width` (encoding.h
        set_padded_output_width); a Composite sets its last nested
        encoding's this way, so the width need not be a multiple of
        anything."""
        if width < self.n_output_dims:
            raise ValueError(f"padded width {width} < output width {self.n_output_dims}")
        self._explicit_padded_width = int(width)

    # -- parameters ---------------------------------------------------------
    @property
    def n_params(self) -> int:
        return 0

    def init_params(self, generator: torch.Generator) -> torch.Tensor:
        """Initial fp32 parameter vector on the CPU (empty for fixed-function
        encodings)."""
        return torch.zeros(0, dtype=torch.float32)

    def layer_sizes(self):
        """(rows, cols) of *matrix* params; encodings have none (object.h:97)."""
        return []

    # -- compute -------------------------------------------------------------
    @abc.abstractmethod
    def apply_unpadded(self, params, x, *, compute_dtype=COMPUTE_DTYPE):
        """Encode `x` [B, n_dims_to_encode] -> [B, n_output_dims]."""

    def apply(self, params, x, *, compute_dtype=COMPUTE_DTYPE):
        """Encode and pad to `padded_output_width`."""
        y = self.apply_unpadded(params, x, compute_dtype=compute_dtype)
        if self.n_to_pad:
            y = F.pad(y, (0, self.n_to_pad), value=self.pad_value)
        return y

    # -- config echo ---------------------------------------------------------
    @abc.abstractmethod
    def hyperparams(self) -> dict:
        ...

    def update_hyperparams(self, params: dict) -> None:
        """Live hyperparameter updates (object.h:52-57). Default: no-op."""

    def __repr__(self):
        return f"{type(self).__name__}({self.hyperparams()})"
