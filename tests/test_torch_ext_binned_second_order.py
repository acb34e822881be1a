"""The second order of K12/K13's twins (ExtLookupFn, ExtLookupScatterFn,
ExtLookupDotsFn in tcnn_tpu_torch/ops/cuda/ext_kernel.py) against
tcnn_tpu's binned route (_binned_ext_backward_bwd, binned_kernel.py:
1833-1862, Pallas in interpret mode), on the inputs of
test_torch_ext_binned.py: the gradient of sum(dcw^2) + sum(dT * S), the
eikonal pattern, in the table, the weights and the cotangent gy.

Tolerances: the weight and gy parts 1e-6 (measured bit-equal: the same bf16 gathers and
bf16 K12 outputs, the same f32 dots); the table part 1e-3 norm-relative,
the binned scatter's second bf16 rounding of its per-slot sums as in the
first order (measured 2.5e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tcnn_tpu.ops.pallas import binned_kernel as bk
from tcnn_tpu_torch.ops.cuda import ext_kernel as ek
from test_torch_ext_binned import NL, F, T, _rel, binned_case

BOUNDS = {"table": 1e-3, "cw": 1e-6, "gy": 1e-6}


@pytest.fixture(scope="module")
def second_order():
    bp, table, local, glob, cw, gy = binned_case(seed=1)
    s = np.random.default_rng(2).normal(size=table.size).astype(np.float32)
    jl = jnp.asarray(local)

    def look(t, w):
        return bk.binned_ext_lookup(bp, t, jl, w).astype(jnp.float32)

    def loss(t, w, g):
        _, vjp = jax.vjp(look, t, w)
        dt, dw = vjp(g)
        return jnp.sum(dw * dw) + jnp.sum(dt * s)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(table), jnp.asarray(cw),
                                                 jnp.asarray(gy))
    spec = ek.ExtSpec(NL * T, F, torch.bfloat16, NL)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (table, cw, gy)]
    y = ek.ExtLookupFn.apply(leaves[0], leaves[1], glob, spec)
    dt, dw = torch.autograd.grad(y.float(), leaves[:2], grad_outputs=leaves[2], create_graph=True)
    got = torch.autograd.grad((dw * dw).sum() + (dt * torch.from_numpy(s)).sum(), leaves)
    return {p: (g, np.asarray(w)) for p, g, w in zip(("table", "cw", "gy"), got, want)}


@pytest.mark.parametrize("part", ["table", "cw", "gy"])
def test_lookup_second_order_matches_binned(second_order, part):
    got, want = second_order[part]
    assert np.abs(want).max() > 0
    assert _rel(got, want) <= BOUNDS[part]
