"""K12's and K13's twins (tcnn_tpu_torch/ops/cuda/ext_kernel.py) against
tcnn_tpu's binned route for externally indexed tables
(binned_kernel.binned_ext_lookup, the ext_iw mode of its _bin, _gather,
_combine, _place, _scatter and _combine_extg kernels, Pallas in interpret
mode): the forward and the first order here, the second order in
test_torch_ext_binned_second_order.py. Q = 32 (t_rows = 2^15, the smallest
table the binned route takes), two tables of F = 2, as
tests/test_ppng_binned.py sizes them; its plan drops no pick on these
inputs (asserted), so both compute the same function.

Tolerances: the forward bit-equal (the same bf16 table values weighted and
summed over corners 0..7 in f32, one rounding to bf16); the weight
gradient dcw bit-equal (the same f32 dot over features); the table
gradient 5e-4 norm-relative: both add bf16(cw * gy) per pick, but the
binned scatter rounds its f32 per-slot sums to bf16 once more before its
placement matmul (binned_kernel.py:1127-1142; measured 1.1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tcnn_tpu.ops.pallas import binned_kernel as bk
from tcnn_tpu_torch.ops.cuda import ext_kernel as ek

NL, T, F, C, B = 2, 1 << 15, 2, 8, 256


def _rel(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def binned_case(seed=0):
    """The plan, and numpy/torch inputs: an O(1) table (U(+-1e-4) would
    hide bf16 differences), level-local f32 rows for JAX and global int32
    rows for the port, weights, a cotangent gy."""
    bp = bk.make_ext_binned_plan(NL, T, F, 3)
    rng = np.random.default_rng(seed)
    table = rng.normal(size=NL * T * F).astype(np.float32)
    local = rng.integers(0, T, (B, C * NL))
    glob = torch.from_numpy((local + (np.arange(C * NL) % NL) * T).astype(np.int32))
    cw = rng.uniform(0, 1, (B, C * NL)).astype(np.float32)
    gy = rng.normal(size=(B, NL * F)).astype(np.float32)
    return bp, table, local.astype(np.float32), glob, cw, gy


@pytest.fixture(scope="module")
def binned():
    bp, table, local, glob, cw, gy = binned_case()
    jl = jnp.asarray(local)

    def look(t, w):
        return bk.binned_ext_lookup(bp, t, jl, w).astype(jnp.float32)

    with pltpu.force_tpu_interpret_mode():
        drops = bk.count_ext_drops(bp, jl, jnp.asarray(cw))
        y, vjp = jax.vjp(look, jnp.asarray(table), jnp.asarray(cw))
        dt, dw = vjp(jnp.asarray(gy))
    spec = ek.ExtSpec(NL * T, F, torch.bfloat16, NL)
    t = torch.from_numpy(table).requires_grad_(True)
    w = torch.from_numpy(cw).requires_grad_(True)
    yt = ek.ExtLookupFn.apply(t, w, glob, spec)
    dtt, dwt = torch.autograd.grad(yt.float(), (t, w), grad_outputs=torch.from_numpy(gy))
    return dict(drops=drops, y=np.asarray(y), dt=np.asarray(dt), dw=np.asarray(dw),
                yt=yt.detach(), dtt=dtt, dwt=dwt)


def test_binned_plan_drops_no_pick(binned):
    assert binned["drops"] == 0


def test_lookup_twin_forward_is_bit_equal_to_binned(binned):
    assert binned["yt"].dtype == torch.bfloat16
    np.testing.assert_array_equal(binned["yt"].float().numpy(), binned["y"])


def test_lookup_table_gradient_matches_binned(binned):
    assert _rel(binned["dtt"], binned["dt"]) < 5e-4


def test_lookup_weight_gradient_is_bit_equal_to_binned(binned):
    np.testing.assert_array_equal(binned["dwt"].numpy(), binned["dw"])
