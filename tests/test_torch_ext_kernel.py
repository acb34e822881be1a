"""The port's externally indexed table lookups (tcnn_tpu_torch/ops/cuda/
ext_kernel.py): the plain twins of K10-K13 against tcnn_tpu's dense-ext
kernels (dense_ext_kernel.py, Pallas in interpret mode) on the same inputs,
and the autograd Functions' algebra in float64. The binned route's parity
is in test_torch_ext_binned*.py.

Tolerances:
  - K10's twin against dense_ext_gather: bit-equal (both return the bf16
    table's own values);
  - K11's twin against dense_ext_scatter: 1e-6 norm-relative (both add the
    same bf16-rounded contributions in f32; only the order differs);
  - K12/K13's twins against PPNG3's dense-ext formulation (dense_ext_gather,
    then a jnp weighted sum over corners, ppng.py:572-584): the forward
    bit-equal (both sum corners 0..7 in f32, one rounding to bf16); the
    table and weight gradients and the second order 1e-6 norm-relative
    (summation order), but for the second order's gy part (bf16, see
    SECOND_ORDER_REL).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tcnn_tpu.ops.pallas import dense_ext_kernel as dk
from tcnn_tpu_torch.ops.cuda import ext_kernel as ek
from tcnn_tpu_torch.utils import profiling

NL, T, C, B = 3, 64, 4, 300


def _rel(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _inputs(f, c=C, nl=NL, t=T, b=B, seed=0):
    """(flat f32 table [nl*t*f], level-local f32 idx [b, c*nl] as JAX takes
    it, global int32 idx as the port takes it)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=nl * t * f).astype(np.float32)
    local = rng.integers(0, t, (b, c * nl))
    glob = local + (np.arange(c * nl) % nl) * t
    return table, local.astype(np.float32), torch.from_numpy(glob.astype(np.int32))


@pytest.mark.parametrize("f", [1, 2, 4, 8, 16])
def test_gather_twin_is_bit_equal_to_dense_ext_gather(f):
    table, local, idx = _inputs(f)
    assert dk.supported(NL, T, f)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(dk.dense_ext_gather(NL, T, f, C, jnp.asarray(table), jnp.asarray(local)))
    tb = torch.from_numpy(table).reshape(-1, f).to(torch.bfloat16)
    got = ek.ext_gather(tb, idx)
    assert got.dtype == torch.bfloat16 and got.shape == (B, C * NL * f)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("f", [1, 2, 4, 8, 16])
def test_scatter_twin_matches_dense_ext_scatter(f):
    table, local, idx = _inputs(f, seed=1)
    ct = np.random.default_rng(2).normal(size=(B, C * NL * f)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(dk.dense_ext_scatter(NL, T, f, C, jnp.asarray(local), jnp.asarray(ct)))
    # the port hands K11 the cotangent in the gathered table's dtype, bf16
    got = ek.ext_scatter(idx, torch.from_numpy(ct).to(torch.bfloat16), NL * T)
    assert got.dtype == torch.float32 and got.shape == (NL * T, f)
    assert _rel(got, want) < 1e-6
    # unrounded contributions are another function: the bound tells them apart
    assert _rel(ek.ext_scatter(idx, torch.from_numpy(ct), NL * T), want) > 1e-4


def test_gather_function_gradient_is_dense_ext_vjp():
    """ExtGatherFn's backward (ExtScatterFn, K11's twin) against jax.grad
    through dense_ext_gather, and its second derivative (ExtGatherFn again)
    against the scatter's own vjp."""
    f = 4
    table, local, idx = _inputs(f, seed=3)
    ct = np.random.default_rng(4).normal(size=(B, C * NL * f)).astype(np.float32)
    spec = ek.ExtSpec(NL * T, f, torch.bfloat16, NL)

    def jloss(t):
        return jnp.sum(dk.dense_ext_gather(NL, T, f, C, t, jnp.asarray(local)).astype(jnp.float32)
                       * ct)

    with pltpu.force_tpu_interpret_mode():
        gj = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
        gg = np.asarray(jax.grad(lambda c_: jnp.sum(
            dk.dense_ext_scatter(NL, T, f, C, jnp.asarray(local), c_) * jnp.asarray(table)))(
                jnp.asarray(ct)))
    p = torch.from_numpy(table).requires_grad_(True)
    (gt,) = torch.autograd.grad((ek.ExtGatherFn.apply(p, idx, spec).float()
                                 * torch.from_numpy(ct)).sum(), p)
    assert _rel(gt, gj) < 1e-6
    c = torch.from_numpy(ct).requires_grad_(True)
    (gc,) = torch.autograd.grad((ek.ExtScatterFn.apply(c, idx, spec)
                                 * torch.from_numpy(table)).sum(), c)
    np.testing.assert_array_equal(gc.numpy(), gg)


# -- K12 / K13 against PPNG3's dense-ext formulation ------------------------

NL3, T3, C3, B3 = 2, 512, 8, 256


def _lookup_inputs(f, seed=5):
    table, local, idx = _inputs(f, c=C3, nl=NL3, t=T3, b=B3, seed=seed)
    rng = np.random.default_rng(seed + 1)
    cw = rng.uniform(0, 1, (B3, C3 * NL3)).astype(np.float32)
    gy = rng.normal(size=(B3, NL3 * f)).astype(np.float32)
    return table, local, idx, cw, gy


def _jax_lookup(f, table, local, cw):
    """ppng.py:581-584: raw bf16 picks times the weights, summed over corners."""
    picks = dk.dense_ext_gather(NL3, T3, f, C3, table, local)
    picks = picks.reshape(B3, C3, NL3 * f).astype(jnp.float32)
    cw_e = jnp.repeat(cw.reshape(B3, C3, NL3), f, axis=2)
    return jnp.sum(picks * cw_e, axis=1).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def dense_lookup():
    """tcnn_tpu's dense-ext lookup of PPNG3 at F = 2, in interpret mode:
    forward, the vjp for gy (table and weights), and the second order of
    the eikonal pattern sum(dcw^2) + sum(dT * S) in (table, cw, gy)."""
    f = 2
    table, local, idx, cw, gy = _lookup_inputs(f)
    s = np.random.default_rng(9).normal(size=table.size).astype(np.float32)
    jl = jnp.asarray(local)

    def first(t, w, g):
        # one vjp per input, and the table's own vjp taken at a constant
        # table (dT does not depend on T): JAX cannot differentiate a vjp of
        # a custom_vjp function in the variable it was taken with respect to
        _, vjp_t = jax.vjp(lambda t_: _jax_lookup(f, t_, jl, w).astype(jnp.float32),
                           jax.lax.stop_gradient(t))
        _, vjp_w = jax.vjp(lambda w_: _jax_lookup(f, t, jl, w_).astype(jnp.float32), w)
        return vjp_t(g)[0], vjp_w(g)[0]

    def second(t, w, g):
        dt, dw = first(t, w, g)
        return jnp.sum(dw * dw) + jnp.sum(dt * s)

    with pltpu.force_tpu_interpret_mode():
        args = (jnp.asarray(table), jnp.asarray(cw), jnp.asarray(gy))
        y = _jax_lookup(f, args[0], jl, args[1])
        dt, dw = first(*args)
        g2 = jax.grad(second, argnums=(0, 1, 2))(*args)
    return dict(f=f, table=table, idx=idx, cw=cw, gy=gy, s=s,
                y=np.asarray(y.astype(jnp.float32)), dt=np.asarray(dt), dw=np.asarray(dw),
                g2=[np.asarray(g) for g in g2])


def _port_first(r, create_graph=False):
    spec = ek.ExtSpec(NL3 * T3, r["f"], torch.bfloat16, NL3)
    t = torch.from_numpy(r["table"]).requires_grad_(True)
    w = torch.from_numpy(r["cw"]).requires_grad_(True)
    g = torch.from_numpy(r["gy"]).requires_grad_(True)
    y = ek.ExtLookupFn.apply(t, w, r["idx"], spec)
    dt, dw = torch.autograd.grad(y.float(), (t, w), grad_outputs=g, create_graph=create_graph)
    return y, dt, dw, (t, w, g)


def test_lookup_twin_forward_is_bit_equal_to_dense_ext(dense_lookup):
    y, _, _, _ = _port_first(dense_lookup)
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.detach().float().numpy(), dense_lookup["y"])


def test_lookup_table_gradient_matches_dense_ext(dense_lookup):
    _, dt, _, _ = _port_first(dense_lookup)
    assert _rel(dt, dense_lookup["dt"]) < 1e-6


def test_lookup_weight_gradient_matches_dense_ext(dense_lookup):
    _, _, dw, _ = _port_first(dense_lookup)
    assert _rel(dw, dense_lookup["dw"]) < 1e-6


#: The second order's gy part is K12's output, which the port (as the
#: binned route, binned_kernel.py:1849-1851) rounds to bf16 where the
#: dense-ext route's jnp sum keeps f32: 2^-9 relative per value (measured
#: 1.6e-3); the other parts differ only in summation order.
SECOND_ORDER_REL = {"table": 1e-6, "cw": 1e-6, "gy": 4e-3}


@pytest.mark.parametrize("part", ["table", "cw", "gy"])
def test_lookup_second_order_matches_dense_ext(dense_lookup, part):
    r = dense_lookup
    _, dt, dw, leaves = _port_first(r, create_graph=True)
    loss = (dw * dw).sum() + (dt * torch.from_numpy(r["s"])).sum()
    got = torch.autograd.grad(loss, leaves)
    i = ("table", "cw", "gy").index(part)
    assert _rel(got[i], r["g2"][i]) < SECOND_ORDER_REL[part]


def test_one_backward_launch_gives_both_gradients():
    """Without a graph of the backward, ExtLookupFn's backward takes one
    K13 call for both halves; with one it takes the two Functions. Both
    give the same values."""
    r = dict(zip(("table", "local", "idx", "cw", "gy"), _lookup_inputs(4, seed=11)), f=4)
    _, dt, dw, _ = _port_first(r)
    _, dt2, dw2, _ = _port_first(r, create_graph=True)
    np.testing.assert_array_equal(dt.numpy(), dt2.detach().numpy())
    np.testing.assert_array_equal(dw.numpy(), dw2.detach().numpy())


# -- the Functions' algebra in float64 (twins without rounding) -------------


def _f64_case(seed=0, b=5, c=2, nl=2, t=3, f=2):
    rng = np.random.default_rng(seed)
    spec = ek.ExtSpec(nl * t, f, torch.float64, nl)
    idx = torch.from_numpy((rng.integers(0, t, (b, c * nl)) + (np.arange(c * nl) % nl) * t)
                           .astype(np.int32))

    def leaf(*shape):
        return torch.from_numpy(rng.normal(size=shape)).requires_grad_(True)

    return spec, idx, leaf(nl * t * f), leaf(b, c * nl), leaf(b, nl * f), leaf(b, c * nl * f)


def test_gather_scatter_pair_gradcheck():
    spec, idx, table, _, _, ct = _f64_case()
    assert torch.autograd.gradcheck(lambda t: ek.ExtGatherFn.apply(t, idx, spec), (table,))
    assert torch.autograd.gradcheck(lambda c: ek.ExtScatterFn.apply(c, idx, spec), (ct,))
    # nonlinear in its input through a square, so the second order is not trivial
    assert torch.autograd.gradgradcheck(lambda t: ek.ExtGatherFn.apply(t, idx, spec) ** 2,
                                        (table,))


@pytest.mark.parametrize("fn", ["lookup", "scatter", "dots"])
def test_lookup_functions_gradcheck(fn):
    spec, idx, table, cw, gy, _ = _f64_case(seed=1)
    f = {"lookup": lambda t, w, g: ek.ExtLookupFn.apply(t, w, idx, spec),
         "scatter": lambda t, w, g: ek.ExtLookupScatterFn.apply(w, g, idx, spec),
         "dots": lambda t, w, g: ek.ExtLookupDotsFn.apply(t, g, idx, spec)}[fn]
    args = (table, cw, gy)
    assert torch.autograd.gradcheck(f, args)
    assert torch.autograd.gradgradcheck(f, args)


def test_third_derivative_of_the_lookup():
    """The gradient of the lookup's gradient's gradient: gradgradcheck of
    the first derivative (a create_graph backward) is a third-order check."""
    spec, idx, table, cw, gy, _ = _f64_case(seed=2)

    def first(t, w, g):
        y = ek.ExtLookupFn.apply(t, w, idx, spec)
        dt, dw = torch.autograd.grad(y, (t, w), grad_outputs=g, create_graph=True)
        return dt, dw ** 2

    assert torch.autograd.gradgradcheck(first, (table, cw, gy))


def test_cpu_tensors_launch_no_kernel():
    spec, idx, table, cw, gy, ct = _f64_case(seed=3)
    before = profiling.counts("launches.")
    y = ek.ExtLookupFn.apply(table, cw, idx, spec)
    (dw,) = torch.autograd.grad(y, cw, grad_outputs=gy, create_graph=True)
    dw.sum().backward()
    (ek.ExtGatherFn.apply(table, idx, spec) * ct).sum().backward()
    assert profiling.counts("launches.") == before


def test_wrappers_refuse_bad_operands():
    spec, idx, table, cw, gy, ct = _f64_case(seed=4)
    with pytest.raises(ValueError, match="int32"):
        ek.ext_gather(table.detach().reshape(-1, 2), idx.long())
    with pytest.raises(ValueError, match="multiple of NL"):
        ek.ext_lookup(table.detach().reshape(-1, 2), idx[:, :3], cw.detach()[:, :3], 2)
    with pytest.raises(ValueError, match="differ"):
        ek.ext_lookup(table.detach().reshape(-1, 2), idx, cw.detach()[:, :2], 2)
    with pytest.raises(ValueError, match="ct must be"):
        ek.ext_scatter(idx, ct.detach()[:, :3], 6)
