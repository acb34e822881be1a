"""The grid encoding at a padded width that is not a multiple of F
(`create_encoding(..., alignment=6)` at F = 4 pads 64 columns to 66, F = 8
at alignment 12 pads 128 to 132), on the CPU.

K1 stores F columns at a time into rows whose width is a multiple of F, so
`grid_kernel.grid_encode` encodes such a width into the next multiple of F
and copies out its leading columns, and the backward kernels (K4, K7, K8),
which read F columns a load, get the cotangent's leading L*F columns
(`grid_kernel._cut_to_levels`). These hold the port against the JAX
package's Pallas forward (interpret mode) within one bf16 ulp, as
tests/test_torch_grid.py does at aligned widths, and its gradients at the
odd width against the same encoding's at its unpadded width, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tcnn_tpu as tc
import tcnn_tpu_torch as tt

WIDTHS = [(4, 6, 66), (8, 12, 132)]


def _cfg(f):
    return {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": f,
            "log2_hashmap_size": 12, "base_resolution": 4, "per_level_scale": 1.5}


def _pair(f, alignment, seed):
    je = tc.create_encoding(3, _cfg(f), alignment=alignment)
    te = tt.create_encoding(3, _cfg(f), alignment=alignment)
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, je.n_params).astype(np.float32)
    x = rng.uniform(0, 1, (257, 3)).astype(np.float32)
    return je, te, p, x


@pytest.mark.parametrize("f,alignment,width", WIDTHS)
def test_odd_width_matches_pallas(f, alignment, width):
    je, te, p, x = _pair(f, alignment, seed=f)
    assert je.padded_output_width == te.padded_output_width == width and width % f
    with pltpu.force_tpu_interpret_mode():
        want = je.apply(jnp.asarray(p), jnp.asarray(x), impl="pallas", needs_input_grad=False)
    want = np.asarray(want.astype(jnp.float32))
    got = te.apply(torch.from_numpy(p), torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (257, width)
    assert got.is_contiguous()
    got = got.float().numpy()
    bad = np.abs(got - want) > 2.0**-7 * np.maximum(np.abs(got), np.abs(want))
    assert not bad.any(), f"{bad.sum()} values differ by more than one bf16 ulp"
    assert not got[:, 16 * f:].any()


@pytest.mark.parametrize("f,alignment,width", WIDTHS)
def test_odd_width_gradients_equal_unpadded(f, alignment, width):
    _, te, p, x = _pair(f, alignment, seed=10 + f)
    rng = np.random.default_rng(20 + f)
    ct = torch.from_numpy(rng.normal(size=(257, width)).astype(np.float32))
    L = 16 * f

    def grads(w, input_grads):
        params = torch.from_numpy(p).requires_grad_(True)
        xx = torch.from_numpy(x).requires_grad_(input_grads)
        c = ct.clone().requires_grad_(True)  # a cotangent that depends on a leaf, as the MLP's does
        y = te._encode(params, xx, w, None, input_grads)
        assert y.shape[1] == w
        loss = (y.float() * c[:, :w]).sum()
        if not input_grads:
            return torch.autograd.grad(loss, params)
        # second order: the eikonal-style loss on dL/dx, through K8's dL/dgy too
        (gx,) = torch.autograd.grad(loss, xx, create_graph=True)
        gp, gc = torch.autograd.grad((gx**2).sum(), (params, c))
        assert not gc[:, L:].any()
        return gx.detach(), gp, gc[:, :L]

    for input_grads in (False, True):
        odd, even = grads(width, input_grads), grads(L, input_grads)
        for a, b in zip(odd, even):
            assert torch.equal(a, b)
