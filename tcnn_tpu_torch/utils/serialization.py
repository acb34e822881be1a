"""Binary-in-JSON serialization helpers (counterpart of
``tcnn_tpu/utils/serialization.py:17-54``): base64-encoded little-endian
arrays inside plain JSON, the format both packages' checkpoints use.

Optimizer state is a flat dict of tensors. `tcnn_tpu` stores it with
`jax.tree_util`, which flattens a dict in sorted-key order and names the
structure by its treedef string; `tree_to_json`/`tree_from_json` write and
read the leaves in that order under the same string, so snapshots cross
between the packages. Integer leaves (step counters) are uint32 in the
snapshot and int64 on the port's device.
"""

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


def treedef_string(tree: dict) -> str:
    """`str(jax.tree_util.tree_structure(tree))` for a flat dict of arrays."""
    return "PyTreeDef({" + ", ".join(f"'{k}': *" for k in sorted(tree)) + "})"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype.is_floating_point:
        return t.float().numpy()
    return t.numpy().astype(np.uint32)


def tree_to_json(tree: dict) -> dict:
    """A flat dict of tensors in `tcnn_tpu`'s `tree_to_json` format."""
    return {
        "treedef": treedef_string(tree),
        "leaves": [array_to_json(_to_numpy(tree[k])) for k in sorted(tree)],
    }


def tree_from_json(obj, like: dict) -> dict:
    """A dict with the keys, dtypes, shapes and devices of `like`, from
    leaves serialized by `tree_to_json` here or in `tcnn_tpu`."""
    keys = sorted(like)
    stored = [array_from_json(o) for o in obj["leaves"]]
    if len(stored) != len(keys):
        raise ValueError(f"checkpoint has {len(stored)} leaves, expected {len(keys)}")
    if obj.get("treedef", treedef_string(like)) != treedef_string(like):
        raise ValueError(f"checkpoint state {obj['treedef']} does not match {treedef_string(like)}")
    return opt_state_from_jax(dict(zip(keys, stored)), like)


def opt_state_from_jax(state: dict, like: dict) -> dict:
    """The port's optimizer state from a `tcnn_tpu` state passed as numpy
    arrays (`{k: np.asarray(v) for k, v in trainer.state["opt"].items()}`),
    shaped, typed and placed like `like` (the port's `init_state()`)."""
    if sorted(state) != sorted(like):
        raise ValueError(f"state keys {sorted(state)} do not match {sorted(like)}")
    out = {}
    for k, ref in like.items():
        arr = np.asarray(state[k])
        if arr.size != ref.numel():
            raise ValueError(f"{k}: expected {ref.numel()} values, got {arr.size}")
        arr = arr.astype(np.float32 if ref.dtype.is_floating_point else np.int64)
        out[k] = torch.from_numpy(arr.reshape(tuple(ref.shape))).to(ref.device)
    return out


def params_from_jax(arr: np.ndarray, n_params: int) -> torch.Tensor:
    """The port's flat fp32 params from a `tcnn_tpu` params vector passed
    as numpy (`np.asarray(trainer.params)`). Both packages lay the vector
    out [network | encoding] (network_with_input_encoding.py:49-51), the
    encoding block in the JAX package's own layout (a grid's table, PPNG's
    [F, 2, ...] tables), so this checks the length and dtype and converts."""
    arr = np.asarray(arr)
    if arr.dtype != np.float32:
        raise ValueError(f"expected float32 params, got {arr.dtype}")
    if arr.shape != (n_params,):
        raise ValueError(f"expected {n_params} params, got shape {arr.shape}")
    return torch.from_numpy(arr.copy())
