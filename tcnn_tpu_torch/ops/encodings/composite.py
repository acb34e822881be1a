"""Composite encoding: nested encodings over contiguous slices of the input.

Counterpart of ``tcnn_tpu/ops/encodings/composite.py`` (the reference's
CompositeEncoding, composite.h:136-290):

  - each nested encoding reads `n_dims_to_encode` input dims from its
    `dims_to_encode_begin` (the registry infers the begins and at most one
    remainder);
  - Concatenation (default) pads the LAST nested encoding to
    `next_multiple(total, alignment) - prefix` (composite.h:189-211), so a
    nested grid may end at a width that is not a multiple of its F (K1
    encodes the next multiple and cuts, ``ops/cuda/grid_kernel.py``);
  - Sum and Product need equal nested widths, align every nested encoding
    the same way and reduce the padding columns too (composite.h:47-133);
    they add or multiply in f32 and round to the compute dtype once.

The flat params are the nested encodings' in nesting order, the JAX
layout, so `params_from_jax` carries a JAX model over unchanged. A nested
encoding that declares `supports_input_grad_opt` (the grid) is told
`needs_input_grad`: the port's grid raises on an x that requires a
gradient unless it is, where the JAX grid defaults to True. Each nested
encoding gets its slice of x as a contiguous tensor, as the kernels read
it. The JAX Composite takes no `max_level`, and neither does this one.
"""

from __future__ import annotations

import torch

from ...common import COMPUTE_DTYPE, ReductionType, next_multiple
from .base import Encoding


class CompositeEncoding(Encoding):
    #: passes `needs_input_grad` on to the nested encodings that take it
    supports_input_grad_opt = True

    def __init__(self, n_dims_to_encode: int, nested, dims_to_encode_begin,
                 reduction: ReductionType = ReductionType.Concatenation):
        super().__init__(n_dims_to_encode)
        self.nested = list(nested)
        self.dims_to_encode_begin = [int(o) for o in dims_to_encode_begin]
        self.reduction = reduction
        if reduction != ReductionType.Concatenation and self.nested:
            widths = [e.n_output_dims for e in self.nested]
            if len(set(widths)) > 1:
                raise ValueError(
                    f"Composite Sum/Product reduction requires equal nested output widths, "
                    f"got {widths}")

    # -- shape contract -------------------------------------------------------
    @property
    def n_output_dims(self) -> int:
        if self.reduction == ReductionType.Concatenation:
            # the padding of every nested encoding but the last counts as output
            total = sum(e.padded_output_width for e in self.nested[:-1])
            return total + (self.nested[-1].n_output_dims if self.nested else 0)
        return self.nested[0].n_output_dims if self.nested else 0

    @property
    def padded_output_width(self) -> int:
        if self.reduction == ReductionType.Concatenation:
            return sum(e.padded_output_width for e in self.nested)
        return self.nested[0].padded_output_width if self.nested else 0

    def set_alignment(self, alignment: int) -> None:
        super().set_alignment(alignment)
        if self.reduction != ReductionType.Concatenation:
            for e in self.nested:
                e.set_alignment(self._alignment)
        elif self.nested:
            prefix = sum(e.padded_output_width for e in self.nested[:-1])
            last = self.nested[-1]
            last.set_padded_output_width(
                next_multiple(prefix + last.n_output_dims, self._alignment) - prefix)

    # -- params ---------------------------------------------------------------
    @property
    def n_params(self) -> int:
        return sum(e.n_params for e in self.nested)

    def init_params(self, generator: torch.Generator) -> torch.Tensor:
        parts = [e.init_params(generator) for e in self.nested]
        return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.float32)

    def layer_sizes(self):
        return [s for e in self.nested for s in e.layer_sizes()]

    # -- compute ---------------------------------------------------------------
    def apply_unpadded(self, params, x, *, compute_dtype=COMPUTE_DTYPE):
        raise NotImplementedError("CompositeEncoding pads its nested encodings: call apply")

    def apply(self, params, x, *, needs_input_grad=False, compute_dtype=COMPUTE_DTYPE):
        """[B, n_dims_to_encode] -> [B, padded_output_width] in
        `compute_dtype` (bf16 by default)."""
        outs, off = [], 0
        for enc, begin in zip(self.nested, self.dims_to_encode_begin):
            p = params[off : off + enc.n_params]
            off += enc.n_params
            kw = ({"needs_input_grad": needs_input_grad}
                  if getattr(enc, "supports_input_grad_opt", False) else {})
            # the kernels read a contiguous x
            xi = x[:, begin : begin + enc.n_dims_to_encode].contiguous()
            outs.append(enc.apply(p, xi, compute_dtype=compute_dtype, **kw))
        if not outs:
            return torch.zeros((x.shape[0], 0), dtype=compute_dtype, device=x.device)
        if self.reduction == ReductionType.Concatenation:
            return torch.cat(outs, -1)
        stacked = torch.stack([o.float() for o in outs])
        if self.reduction == ReductionType.Sum:
            return stacked.sum(0).to(compute_dtype)
        return stacked.prod(0).to(compute_dtype)

    def hyperparams(self):
        return {"otype": "Composite", "reduction": self.reduction.value,
                "nested": [e.hyperparams() for e in self.nested]}
