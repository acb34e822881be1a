"""Binary-in-JSON serialization helpers (counterpart of
``tcnn_tpu/utils/serialization.py:17-54``): base64-encoded little-endian
arrays inside plain JSON, the format both packages' checkpoints use.

Optimizer state is a tree of tensors: dicts, and the list Composite keeps
of its nested states. `tcnn_tpu` stores it with `jax.tree_util`, which
flattens a dict in sorted-key order and a list in order and names the
structure by its treedef string; `tree_leaves`, `tree_to_json` and
`tree_from_json` write and read the leaves in that order under the same
string, so snapshots cross between the packages. Integer leaves (step
counters) are uint32 in the snapshot and int64 on the port's device.
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


def tree_leaves(tree) -> list:
    """The leaves of a state tree in `jax.tree_util`'s order: a dict's in
    sorted-key order, a list's in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


def treedef_string(tree) -> str:
    """`str(jax.tree_util.tree_structure(tree))` for a tree of dicts and
    lists of arrays."""
    return f"PyTreeDef({_structure(tree)})"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype.is_floating_point:
        return t.float().numpy()
    return t.numpy().astype(np.uint32)


def tree_to_json(tree) -> dict:
    """A state tree in `tcnn_tpu`'s `tree_to_json` format."""
    return {
        "treedef": treedef_string(tree),
        "leaves": [array_to_json(_to_numpy(leaf)) for leaf in tree_leaves(tree)],
    }


def _unflatten(like, leaves):
    """A tree shaped as `like` of the next items of the iterator `leaves`."""
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return [_unflatten(v, leaves) for v in like]
    return next(leaves)


def tree_from_json(obj, like):
    """A tree with the structure, dtypes, shapes and devices of `like`, from
    leaves serialized by `tree_to_json` here or in `tcnn_tpu`."""
    stored = [array_from_json(o) for o in obj["leaves"]]
    n = len(tree_leaves(like))
    if len(stored) != n:
        raise ValueError(f"checkpoint has {len(stored)} leaves, expected {n}")
    if obj.get("treedef", treedef_string(like)) != treedef_string(like):
        raise ValueError(f"checkpoint state {obj['treedef']} does not match {treedef_string(like)}")
    return opt_state_from_jax(_unflatten(like, iter(stored)), like)


def opt_state_from_jax(state, like):
    """The port's optimizer state from a `tcnn_tpu` state passed as numpy
    arrays (`jax.tree_util.tree_map(np.asarray, trainer.state["opt"])`),
    shaped, typed and placed like `like` (the port's `init_state()`). An
    optimizer that keeps step counts on the host re-reads them with
    `optimizer.load_state` (the Trainer's `deserialize` does)."""
    if isinstance(like, dict):
        if not isinstance(state, dict) or sorted(state) != sorted(like):
            got = sorted(state) if isinstance(state, dict) else type(state).__name__
            raise ValueError(f"state keys {got} do not match {sorted(like)}")
        return {k: opt_state_from_jax(state[k], ref) for k, ref in like.items()}
    if isinstance(like, (list, tuple)):
        if not isinstance(state, (list, tuple)) or len(state) != len(like):
            raise ValueError(f"expected a list of {len(like)} nested states")
        return [opt_state_from_jax(s, ref) for s, ref in zip(state, like)]
    arr = np.asarray(state)
    if arr.size != like.numel():
        raise ValueError(f"expected {like.numel()} values, got {arr.size}")
    arr = arr.astype(np.float32 if like.dtype.is_floating_point else np.int64)
    return torch.from_numpy(arr.reshape(tuple(like.shape))).to(like.device)


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
