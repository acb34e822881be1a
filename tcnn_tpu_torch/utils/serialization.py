"""Binary-in-JSON serialization helpers (counterpart of
``tcnn_tpu/utils/serialization.py:17-30``): base64-encoded little-endian
arrays inside plain JSON, the format both packages' checkpoints use."""

from __future__ import annotations

import base64

import numpy as np
import torch


def array_to_json(arr) -> dict:
    arr = np.asarray(arr)
    return {
        "dtype": arr.dtype.str,
        "shape": list(arr.shape),
        "data": base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode(),
    }


def array_from_json(obj) -> np.ndarray:
    data = base64.b64decode(obj["data"])
    return np.frombuffer(data, dtype=np.dtype(obj["dtype"])).reshape(obj["shape"])


def params_from_jax(arr: np.ndarray, n_params: int) -> torch.Tensor:
    """The port's flat fp32 params from a `tcnn_tpu` params vector passed
    as numpy (`np.asarray(trainer.params)`). Both packages lay the vector
    out [network | encoding] (network_with_input_encoding.py:49-51), so
    this checks the length and dtype and converts."""
    arr = np.asarray(arr)
    if arr.dtype != np.float32:
        raise ValueError(f"expected float32 params, got {arr.dtype}")
    if arr.shape != (n_params,):
        raise ValueError(f"expected {n_params} params, got shape {arr.shape}")
    return torch.from_numpy(arr.copy())
