"""The port's grid kernels at table sizes where tcnn_tpu takes its binned
route (B12, tcnn_tpu/ops/pallas/binned_kernel.py: the bin, gather, combine,
place and scatter stages, Pallas in interpret mode): the forward (K1's
twin) and the table gradient (K4's twin) against
`grid_encode_split`, on the CPU. The binned route serves trailing levels of
at least 2^14 rows that hash or whose uint32 stride wraps; the port
computes them with the kernels of every other table size.

Here the reference-default grid (16 levels, per_level_scale 2.0; 2-D
Linear CoherentPrime) at T=2^14, the smallest table the binned route
takes, where tcnn_tpu has both routes: its dense Pallas kernels take the
whole table (`impl="pallas"`, `_kernel_plan()`), and its binned route
(`grid_encode_split`: levels 0-3 dense, 4-15 binned; at this size every
level past 3 hashes, its stride passing 2^14 before it could wrap)
computes the same function. B = 512, one batch tile. Each comparison with
the binned route asserts that it drops no pick on its inputs
(`count_drops`): the port never drops, so only then are the functions the
same. tests/test_torch_binned_hash.py holds one-level binned grids in 3-D,
with stochastic interpolation, Nearest and the Rng hash;
test_torch_binned_t19.py the T=2^19 plans and a wrap-degenerate level;
test_torch_binned_ig.py the input gradients.

Tolerances:
  - forward: within one bf16 ulp per value (2^-7 relative), as the port is
    held against the dense Pallas kernels (tests/test_torch_grid.py): both
    sum the corners of the same bf16 table values in f32 and round once;
    the Pallas kernels may form a corner weight in another order, one f32
    ulp apart (readings: bit-equal);
  - table gradient against the dense route, tests/test_torch_grid_bwd.py's:
    rtol 1e-5 plus one bf16 ulp of the largest contribution (2^-8 max|gy|),
    since both round each corner's contribution to bf16 once and add them
    in f32 (reading: no value over the bound);
  - table gradient against the binned route, norm-relative BINNED_GRAD_REL
    = 1e-3: both round each pick's w * gy to bf16, but the binned route sums
    the picks that share a (tile, superblock) slot in f32 and rounds that
    sum to bf16 once more before its scatter (binned_kernel.py:974-980,
    1127-1142), where K4's twin adds each rounded contribution in f32
    (readings 1.1e-4 to 2.9e-4; 1.8e-4 here); per level, the gradient's sum
    agrees to 1e-2 relative, as test_binned_kernel.py checks the binned
    route against XLA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu.ops.pallas import binned_kernel as bk

BINNED_GRAD_REL = 1e-3


def enc_cfg(**kw):
    """tests/test_binned_kernel.py:22-31's grid (5 levels, T=2^14, scale 2)
    with the keys `kw` set."""
    cfg = {"otype": "HashGrid", "n_levels": 5, "n_features_per_level": 2,
           "log2_hashmap_size": 14, "base_resolution": 16, "per_level_scale": 2.0}
    cfg.update(kw)
    return cfg


def rel(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def bf16_values(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def within_one_bf16_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bad = np.abs(got - want) > 2.0**-7 * np.maximum(np.abs(got), np.abs(want))
    assert not bad.any(), f"{bad.sum()} values differ by more than one bf16 ulp"


def pair(d, cfg, seed, batch=256, lo=0.02, hi=0.98):
    """The encoding in both packages, tcnn_tpu's split plan, and numpy
    inputs: an O(1) table, x, a cotangent of bf16 values."""
    je, te = tc.create_encoding(d, cfg), tt.create_encoding(d, cfg)
    assert te.n_params == je.n_params
    split = je._binned_split()
    assert split is not None
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, je.n_params).astype(np.float32)
    x = rng.uniform(lo, hi, (batch, d)).astype(np.float32)
    gy = bf16_values(rng.normal(size=(batch, te.n_output_dims)))
    return je, te, split, p, x, gy


def jax_split(split, p, x, gy):
    """(dropped picks, forward f32, table gradient) of `grid_encode_split`
    in interpret mode."""
    xj = jnp.asarray(x)
    with pltpu.force_tpu_interpret_mode():
        drops = bk.count_drops(split, xj)
        y, vjp = jax.vjp(lambda q: bk.grid_encode_split(split, q, xj), jnp.asarray(p))
        (g,) = vjp(jnp.asarray(gy).astype(y.dtype))
    return drops, np.asarray(y, np.float32), np.asarray(g)


def port(te, p, x, gy):
    """(forward f32, table gradient) of the port's encoding (K1's and K4's
    twins through `GridEncodeFn`)."""
    params = torch.from_numpy(p).requires_grad_(True)
    y = te.apply_unpadded(params, torch.from_numpy(x))
    assert y.dtype == torch.bfloat16
    y.backward(torch.from_numpy(gy).to(torch.bfloat16))
    return y.detach().float().numpy(), params.grad.numpy()


def check_binned(te, split, p, x, gy, grad_rel=BINNED_GRAD_REL):
    drops, jy, jg = jax_split(split, p, x, gy)
    assert drops == 0
    py, pg = port(te, p, x, gy)
    assert py.shape == jy.shape
    within_one_bf16_ulp(py, jy)
    assert rel(pg, jg) < grad_rel, rel(pg, jg)
    F = te.n_features_per_level
    for lvl in range(te.n_levels):
        lo, hi = int(te._offsets[lvl]) * F, (int(te._offsets[lvl]) + int(te._sizes[lvl])) * F
        np.testing.assert_allclose(pg[lo:hi].sum(), jg[lo:hi].sum(), rtol=1e-2, atol=1e-3)
    return py, pg


def t14_case():
    """The reference default at T=2^14: the encodings, the split plan and
    the inputs both routes are compared on."""
    je, te, split, p, x, gy = pair(2, enc_cfg(n_levels=16), seed=14, batch=512, lo=0.0, hi=1.0)
    assert je._kernel_plan() is not None
    assert split.n_prefix_levels == 4 and split.binned.n_levels == 12
    assert te.plan.use_hash == (False,) * 4 + (True,) * 12
    return je, te, split, p, x, gy


def test_reference_default_at_t14_matches_the_dense_route():
    je, te, split, p, x, gy = t14_case()

    def dense(q):
        return je.apply_unpadded(q, jnp.asarray(x), impl="pallas", needs_input_grad=False)

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(dense, jnp.asarray(p))
        (want_g,) = vjp(jnp.asarray(gy).astype(want.dtype))
    got, got_g = port(te, p, x, gy)
    within_one_bf16_ulp(got, np.asarray(want, np.float32))
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=1e-5,
                               atol=2.0**-8 * np.abs(gy).max())


def test_reference_default_at_t14_matches_the_binned_route():
    _, te, split, p, x, gy = t14_case()
    check_binned(te, split, p, x, gy)


def test_count_binned_drops_is_zero():
    """The port drops nothing, whatever the inputs (every sample in one
    cell too), so it ignores tcnn_tpu's "warn_binned_drops" key."""
    cfg = enc_cfg(warn_binned_drops=True)
    je, te = tc.create_encoding(2, cfg), tt.create_encoding(2, cfg)
    assert je._binned_split().binned.warn_drops
    p, x = torch.rand(te.n_params), torch.rand(64, 2)
    assert torch.equal(te.apply_unpadded(p, x), tt.create_encoding(2, enc_cfg()).apply_unpadded(p, x))
    assert te.count_binned_drops(x) == 0
    assert te.count_binned_drops(torch.full((64, 2), 0.3137)) == 0
