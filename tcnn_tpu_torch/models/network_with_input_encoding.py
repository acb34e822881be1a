"""Encoding -> Network composition (counterpart of
``tcnn_tpu/models/network_with_input_encoding.py``).

The encoding's padded output width is aligned to the network's minimum
alignment (network_with_input_encoding.h:46-53), and the flat parameter
vector is laid out [network params | encoding params] (:115-130).
"""

from __future__ import annotations

import torch

from ..common import COMPUTE_DTYPE
from ..ops.cuda import train_kernel
from ..ops.encodings.base import Encoding
from .base import Network


class NetworkWithInputEncoding(Network):
    def __init__(self, encoding: Encoding, network_factory):
        """`network_factory(encoding) -> Network` builds the network once the
        encoding's padded width is aligned to the network's demands."""
        self.encoding = encoding
        probe = network_factory(encoding)
        encoding.set_alignment(probe.minimum_alignment)
        self.network = network_factory(encoding)
        super().__init__(encoding.n_dims_to_encode, self.network.n_output_dims)

    @property
    def padded_output_width(self) -> int:
        return self.network.padded_output_width

    @property
    def n_params(self) -> int:
        return self.network.n_params + self.encoding.n_params

    def layer_sizes(self):
        return self.network.layer_sizes() + self.encoding.layer_sizes()

    def split_params(self, params):
        n_net = self.network.n_params
        return params[:n_net], params[n_net:]

    def init_params(self, generator: torch.Generator) -> torch.Tensor:
        net = self.network.init_params(generator)
        return torch.cat([net, self.encoding.init_params(generator)])

    def apply(self, params, x, *, max_level=None, prepare_input_gradients=False,
              _no_fused_ig=False, compute_dtype=COMPUTE_DTYPE):
        """[B, D] -> [B, padded_output_width] in `compute_dtype`, bf16 by
        default (network_with_input_encoding.py:59-111), handed to the
        encoding and the network. Differentiable with respect to `params`: autograd runs K5
        and K4 backward (or the matmul chain's own backward) and returns the
        f32 gradient of the flat vector.

        `prepare_input_gradients` mirrors the reference flag: the output is
        then differentiable with respect to `x` as well, to second order.
        A model that `train_kernel.supported_ig` takes runs the fused route
        (K3 forward, K9 backward; its second order re-runs the composed
        route); every other model, and `_no_fused_ig` (that fallback's
        re-entry guard), runs the composed route: the encoding into the
        MLP's matmul chain. An encoding that declares
        `supports_input_grad_opt` (the grid: K1, K7, K8) is told
        `needs_input_grad`, as the JAX package tells it
        (network_with_input_encoding.py:93-94); any other (PPNG) is
        differentiable in x as it is."""
        if (prepare_input_gradients and not _no_fused_ig and max_level is None
                and compute_dtype == COMPUTE_DTYPE and train_kernel.supported_ig(self)):
            return train_kernel.FusedApplyIgFn.apply(params, x, self)
        net_p, enc_p = self.split_params(params)
        kwargs = {} if max_level is None else {"max_level": max_level}
        if getattr(self.encoding, "supports_input_grad_opt", False):
            kwargs["needs_input_grad"] = prepare_input_gradients
        enc_out = self.encoding.apply(enc_p, x, compute_dtype=compute_dtype, **kwargs)
        return self.network.apply(net_p, enc_out, second_order=prepare_input_gradients,
                                  compute_dtype=compute_dtype)

    def hyperparams(self):
        return {
            "otype": "NetworkWithInputEncoding",
            "encoding": self.encoding.hyperparams(),
            "network": self.network.hyperparams(),
        }
