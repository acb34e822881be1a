"""The port's input-gradient grid path (kernels K7 and K8's plain twins,
`GridIgFn` / `GridIgBackwardFn`, tcnn_tpu_torch/ops/cuda/grid_kernel.py)
against tcnn_tpu on the CPU: `jax.vjp` of its Pallas input-gradient path
in interpret mode (first order, `_bwd_ig_kernel`; the vjp of that vjp,
`_bwd_bwd_kernel`), and the XLA autodiff oracle.

Tolerances (norm-relative per output):
  - against the Pallas path: both read the bf16 table and round each table-
    gradient contribution to bf16; they sum in another order (the Pallas
    kernel sums levels before corners, and a corner weight formed in
    another order flips a contribution's bf16 rounding now and then): 1e-4
    for the table gradients (measured up to 1.8e-5), 1e-5 for dL/dx and
    ct_x (measured up to 5.3e-7) and for ct_gy, which the JAX package
    rounds to bf16, compared after the same rounding (up to 5e-8);
  - against XLA: XLA keeps an f32 table and f32 contributions, so the bound
    holds the bf16 table (2^-9 relative per row) and the bf16 rounding of
    each contribution: 5e-3 (measured 1.3e-3 to 1.8e-3).
The Pallas input-gradient path disagrees with the XLA oracle for x outside
[0, 1] (3-9% measured; its non-ig kernels do not), so the Pallas cases draw
x inside [0, 1] and the XLA cases draw x from [-0.2, 1.2].
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu_torch.ops.cuda import grid_kernel
from tcnn_tpu_torch.utils import profiling

B = 200


def _enc_cfg(**kw):
    cfg = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
           "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 1.6}
    cfg.update(kw)
    return cfg


def _rel(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _inputs(d, cfg, seed, lo, hi):
    je, te = tc.create_encoding(d, cfg), tt.create_encoding(d, cfg)
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, je.n_params).astype(np.float32)
    x = rng.uniform(lo, hi, (B, d)).astype(np.float32)
    gy = np.array(jnp.asarray(rng.normal(size=(B, te.n_output_dims)), jnp.bfloat16)
                  .astype(jnp.float32))  # bf16 values
    z = rng.normal(size=(B, d)).astype(np.float32)
    ct = rng.normal(size=je.n_params).astype(np.float32)
    return je, te, p, x, gy, z, ct


def _port(te, p, x, gy, z, ct):
    """The twins: K7's (gtable, gx), K8's (ct_gy, gtable2, ct_x)."""
    f = te.n_features_per_level
    table = torch.from_numpy(p).reshape(-1, f).to(torch.bfloat16)
    ct_table = None if ct is None else torch.from_numpy(ct).reshape(-1, f).to(torch.bfloat16)
    xt, gyt = torch.from_numpy(x), torch.from_numpy(gy)
    first = grid_kernel._grid_backward_ig_plain(te.plan, table, xt, gyt)
    second = grid_kernel._grid_backward_bwd_plain(te.plan, table, ct_table, xt, gyt,
                                                  torch.from_numpy(z))
    return [t.numpy() for t in first], [t.numpy() for t in second]


def _jax(je, p, x, gy, z, ct, impl):
    """(gparams, gx) = jax.vjp of the encoding, and (ct_params, ct_x, ct_gy)
    = jax.vjp of that vjp for the cotangents (ct, z)."""

    def bwd(pp, xx, gg):
        if impl == "pallas":
            enc = lambda a, b: je.apply_unpadded(a, b, impl="pallas", needs_input_grad=True)  # noqa: E731
            gg = gg.astype(jnp.bfloat16)
        else:
            enc = lambda a, b: je.apply_unpadded(a, b, impl="xla", compute_dtype=jnp.float32)  # noqa: E731
        return jax.vjp(enc, pp, xx)[1](gg)

    with pltpu.force_tpu_interpret_mode():
        first, vjp2 = jax.vjp(bwd, jnp.asarray(p), jnp.asarray(x), jnp.asarray(gy))
        second = vjp2((jnp.asarray(ct), jnp.asarray(z)))
    return [np.asarray(t, np.float32) for t in first], [np.asarray(t, np.float32) for t in second]


# D in {2, 3, 4}, F in {1, 2, 4}, Linear and Smoothstep: a covering set
# (interpret mode runs each case in about 6 s)
_PALLAS_CASES = [("Linear", 2, 2), ("Smoothstep", 3, 1), ("Linear", 4, 4), ("Smoothstep", 2, 4)]


@pytest.mark.parametrize("interp,d,f", _PALLAS_CASES)
def test_twins_match_pallas_vjp(interp, d, f):
    je, te, p, x, gy, z, ct = _inputs(d, _enc_cfg(interpolation=interp, n_features_per_level=f),
                                      seed=10 * d + f, lo=0.02, hi=0.98)
    je._kernel_plan_cache = dataclasses.replace(je._kernel_plan(), batch_tile=256)
    (jg, jx), (jcp, jcx, jcg) = _jax(je, p, x, gy, z, ct, "pallas")
    (pg, px), (pcg, pcp, pcx) = _port(te, p, x, gy, z, ct)
    assert _rel(pg, jg) < 1e-4 and _rel(px, jx) < 1e-5
    assert _rel(pcp, jcp) < 1e-4 and _rel(pcx, jcx) < 1e-5
    # the JAX package returns ct_gy in gy's dtype, bf16
    assert _rel(torch.from_numpy(pcg).to(torch.bfloat16).float().numpy(), jcg) < 1e-5


_XLA_CASES = [(interp, d, f) for interp in ("Linear", "Smoothstep") for d in (2, 3, 4)
              for f in (1, 2, 4)]


@pytest.mark.parametrize("interp,d,f", _XLA_CASES)
def test_twins_match_xla_oracle(interp, d, f):
    je, te, p, x, gy, z, ct = _inputs(d, _enc_cfg(interpolation=interp, n_features_per_level=f),
                                      seed=100 + 10 * d + f, lo=-0.2, hi=1.2)
    (jg, jx), (jcp, jcx, jcg) = _jax(je, p, x, gy, z, ct, "xla")
    (pg, px), (pcg, pcp, pcx) = _port(te, p, x, gy, z, ct)
    for got, want in ((pg, jg), (px, jx), (pcg, jcg), (pcp, jcp), (pcx, jcx)):
        assert _rel(got, want) < 5e-3


def test_without_ct_table_only_z_terms_remain():
    """The eikonal step's case: no cotangent of the table gradient. The
    twin skips the second gather and equals the full twin at ct = 0."""
    je, te, p, x, gy, z, ct = _inputs(3, _enc_cfg(interpolation="Smoothstep"), 7, 0.0, 1.0)
    _, (cg, g2, cx) = _port(te, p, x, gy, z, None)
    _, (cg0, g20, cx0) = _port(te, p, x, gy, z, np.zeros_like(ct))
    for a, b in ((cg, cg0), (g2, g20), (cx, cx0)):
        np.testing.assert_array_equal(a, b)


def test_autograd_functions_compose_the_twins():
    """encoding.apply(needs_input_grad=True) under autograd: the first
    derivative is K7's twin, the second (create_graph) K8's, exactly."""
    je, te, p, x, gy, z, ct = _inputs(3, _enc_cfg(interpolation="Smoothstep"), 8, 0.0, 1.0)
    te.set_alignment(16)  # padded output: the padding columns carry no gradient
    params = torch.from_numpy(p).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = te.apply(params, xt, needs_input_grad=True)
    assert y.dtype == torch.bfloat16 and y.shape == (B, 16)
    gyt = torch.zeros(B, 16)
    gyt[:, : te.n_output_dims] = torch.from_numpy(gy)
    gp, gx = torch.autograd.grad(y, (params, xt), grad_outputs=gyt.to(torch.bfloat16),
                                 create_graph=True)
    (want_g, want_x), _ = _port(te, p, x, gy, z, ct)
    np.testing.assert_array_equal(gp.detach().numpy(), want_g.reshape(-1))
    np.testing.assert_array_equal(gx.detach().numpy(), want_x)
    cp, cx = torch.autograd.grad((gp, gx), (params, xt),
                                 grad_outputs=(torch.from_numpy(ct), torch.from_numpy(z)))
    _, (_, want_cp, want_cx) = _port(te, p, x, gy, z, ct)
    np.testing.assert_array_equal(cp.numpy(), want_cp.reshape(-1))
    np.testing.assert_array_equal(cx.numpy(), want_cx)


def test_third_order_raises():
    te = tt.create_encoding(2, _enc_cfg())
    params = (torch.rand(te.n_params) * 2 - 1).requires_grad_(True)
    x = torch.rand(16, 2, requires_grad=True)
    (gx,) = torch.autograd.grad(te.apply(params, x, needs_input_grad=True).float().sum(), x,
                                create_graph=True)
    (g2,) = torch.autograd.grad((gx ** 2).sum(), params, create_graph=True)
    with pytest.raises(NotImplementedError, match="third-order"):
        torch.autograd.grad(g2.sum(), params)


@pytest.mark.parametrize("cfg,max_level,why", [
    (_enc_cfg(interpolation="Nearest"), None, "Nearest"),
    (_enc_cfg(stochastic_interpolation=True), None, "stochastic"),
    (_enc_cfg(fast_input_grads=False), None, "fast_input_grads=False"),
    (_enc_cfg(), 0.5, "max_level"),
])
def test_uncovered_input_gradients_raise(cfg, max_level, why):
    """The cases the JAX package sends to its XLA autodiff route
    (grid.py:316-356) no longer raise: they take the port's plain route,
    whose value and dL/dx equal tcnn_tpu's XLA route (bf16 output bit for
    bit; dL/dx at rtol 1e-5; tests/test_torch_grid_route.py holds the rest)
    and launch no input-gradient kernel."""
    je, te = tc.create_encoding(2, cfg), tt.create_encoding(2, cfg)
    rng = np.random.default_rng(len(why))
    p = rng.uniform(-1, 1, te.n_params).astype(np.float32)
    x = rng.uniform(0, 1, (8, 2)).astype(np.float32)
    gy = rng.normal(size=(8, te.n_output_dims)).astype(np.float32)
    y, vjp = jax.vjp(lambda xx: je.apply_unpadded(jnp.asarray(p), xx, max_level=max_level,
                                                  needs_input_grad=True).astype(jnp.float32),
                     jnp.asarray(x))
    params = torch.from_numpy(p).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    before = profiling.counts("launches.")
    yt = te.apply_unpadded(params, xt, max_level=max_level, needs_input_grad=True)
    (gx,) = torch.autograd.grad(yt.float(), xt, torch.from_numpy(gy))
    assert profiling.counts("launches.") == before
    np.testing.assert_array_equal(yt.float().detach().numpy(), np.asarray(y))
    np.testing.assert_allclose(gx.numpy(), np.asarray(vjp(jnp.asarray(gy))[0]), rtol=1e-5,
                               atol=1e-5)


def test_fast_input_grads_is_parsed_as_in_jax():
    for cfg in (_enc_cfg(), _enc_cfg(fast_input_grads=False)):
        assert tt.create_encoding(3, cfg).fast_input_grads == tc.create_encoding(3, cfg).fast_input_grads
    assert tt.create_encoding(3, _enc_cfg()).fast_input_grads is True


def test_cpu_tensors_launch_no_kernel():
    te = tt.create_encoding(3, _enc_cfg())
    before = profiling.counts("launches.")
    params = (torch.rand(te.n_params) * 2 - 1).requires_grad_(True)
    x = torch.rand(32, 3, requires_grad=True)
    (gx,) = torch.autograd.grad(te.apply(params, x, needs_input_grad=True).float().sum(), x,
                                create_graph=True)
    (gx ** 2).sum().backward()
    assert profiling.counts("launches.") == before


def test_per_sample_max_level_matches_jax():
    """A max_level array [B] clamps each sample's levels after the
    encoding, as tcnn_tpu's `_mask_max_level` does (grid.py:381-391): the
    output and its table gradient, against the JAX package's Pallas
    route (interpret mode)."""
    cfg = _enc_cfg(n_levels=6)
    je, te = tc.create_encoding(2, cfg), tt.create_encoding(2, cfg)
    je._kernel_plan_cache = dataclasses.replace(je._kernel_plan(), batch_tile=256)
    rng = np.random.default_rng(0)
    p = rng.uniform(-1, 1, je.n_params).astype(np.float32)
    x = rng.uniform(0, 1, (B, 2)).astype(np.float32)
    ml = rng.uniform(0, 1, B).astype(np.float32)
    ml[:3] = (0.0, 0.5, 1.0)  # a level boundary: l < ml * L + 1e-3 in f32
    gy = rng.normal(size=(B, te.n_output_dims)).astype(np.float32)

    def f(q):
        return je.apply_unpadded(q, jnp.asarray(x), max_level=jnp.asarray(ml), impl="pallas",
                                 needs_input_grad=False)

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(f, jnp.asarray(p))
        (want_g,) = vjp(jnp.asarray(gy).astype(jnp.bfloat16))
    params = torch.from_numpy(p).requires_grad_(True)
    got = te.apply_unpadded(params, torch.from_numpy(x), max_level=torch.from_numpy(ml))
    got_np, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    # the masked levels are zero in both; elsewhere one bf16 ulp (the Pallas
    # kernel forms corner weights in another order, test_torch_grid_bwd.py)
    keep = np.arange(6)[None, :] < ml[:, None] * np.float32(6) + np.float32(1e-3)
    keep = np.repeat(keep, 2, axis=1)
    assert not got_np[~keep].any() and not want[~keep].any()
    np.testing.assert_allclose(got_np, want, rtol=2.0**-7, atol=0)
    got.backward(torch.from_numpy(gy).to(torch.bfloat16))
    np.testing.assert_allclose(params.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=2.0**-8 * np.abs(gy).max())
    with pytest.raises(ValueError, match="per-sample"):
        te.active_levels(ml)
