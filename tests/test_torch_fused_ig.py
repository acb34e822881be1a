"""The port's fused input-gradient route (kernel K9's plain twin,
`FusedApplyIgFn` / `FusedIgBackwardFn`, `supported_ig`;
tcnn_tpu_torch/ops/cuda/train_kernel.py) against tcnn_tpu's
`fused_apply_ig` in interpret mode, after tests/test_fused_ig.py, on the
CPU.

Tolerances (norm-relative):
  - Sigmoid hidden units, the strict cases: the twin and the Pallas kernel
    run the same bf16 forward and keep g in f32 through the MLP backward;
    they differ in summation order and in corner weights formed in another
    order (one f32 ulp, which can flip a bf16 rounding of the encoding or
    of a table contribution): 1e-5 on every gradient (measured up to
    4.1e-7);
  - ReLU hidden units: one flipped bf16 rounding can flip a ReLU mask and
    move a small batch's gradient by percent (tests/test_fused_ig.py:25-32):
    0.2, the JAX package's own bound (measured 2.2e-7: no flip here);
  - second order through the composed fallback (`_fib_bwd`): the table
    part 1e-3 (measured 3.4e-5); the MLP weights part 5e-3 (measured
    1.5e-3): the chain's weights are cast to bf16, so in both packages their
    cotangent is bf16, rounded at other points of the chain (2^-9 relative
    per value).
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
from tcnn_tpu.ops.pallas.train_kernel import fused_apply_ig
from tcnn_tpu.ops.pallas.train_kernel import supported_ig as jax_supported_ig
from tcnn_tpu_torch.ops.cuda import train_kernel

F32 = jnp.float32


def _cfgs(interp="Linear", activation="Sigmoid", **enc):
    return ({"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
             "log2_hashmap_size": 9, "base_resolution": 4, "per_level_scale": 1.7,
             "interpolation": interp, **enc},
            {"otype": "FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 2,
             "activation": activation, "output_activation": "None"})


def _pair(n_dims=2, seed=0, b=256, **kw):
    """Both packages' models from one config, the JAX params (table redrawn
    at O(1), so bf16 differences show) carried into the port, and x."""
    enc, net = _cfgs(**kw)
    jm = tc.create_network_with_input_encoding(n_dims, 1, enc, net)
    jm.encoding._kernel_plan_cache = dataclasses.replace(jm.encoding._kernel_plan(),
                                                         batch_tile=256)
    tm = tt.create_network_with_input_encoding(n_dims, 1, enc, net)
    rng = np.random.default_rng(seed)
    p = np.asarray(jm.init_params(jax.random.PRNGKey(3))).copy()
    n_net = jm.network.n_params
    p[n_net:] = rng.standard_normal(p.size - n_net).astype(np.float32) * 0.5
    x = rng.uniform(0.05, 0.95, (b, n_dims)).astype(np.float32)
    return jm, tm, p, x


def _rel(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _jax_first_order(jm, p, x, gyw):
    def fused(pp, xx):
        return jnp.sum(fused_apply_ig(jm, pp, xx).astype(F32) * gyw)

    with pltpu.force_tpu_interpret_mode():
        return jax.grad(fused, argnums=(0, 1))(jnp.asarray(p), jnp.asarray(x))


def _port_first_order(tm, p, x, gyw):
    params = tt.params_from_jax(p, tm.n_params).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm.apply(params, xt, prepare_input_gradients=True)
    return torch.autograd.grad((out.float() * torch.from_numpy(gyw)).sum(), (params, xt))


@pytest.mark.parametrize("interp,n_dims,f", [
    pytest.param("Linear", 2, 2, id="Linear-2"),
    pytest.param("Smoothstep", 3, 2, id="Smoothstep-3"),
    # 8 features per level: two float4 atomics a corner in K9's scatter
    pytest.param("Linear", 2, 8, id="Linear-2-F8"),
])
def test_first_order_matches_fused_apply_ig(interp, n_dims, f):
    jm, tm, p, x = _pair(n_dims=n_dims, interp=interp, n_features_per_level=f)
    assert tm.encoding.plan.f == f and train_kernel.supported_ig(tm)
    gyw = np.random.default_rng(1).standard_normal((x.shape[0], 16)).astype(np.float32)
    jg, jx = _jax_first_order(jm, p, x, jnp.asarray(gyw))
    pg, px = _port_first_order(tm, p, x, gyw)
    n_net = tm.network.n_params
    assert _rel(pg[:n_net], jg[:n_net]) < 1e-5
    assert _rel(pg[n_net:], jg[n_net:]) < 1e-5
    assert _rel(px, jx) < 1e-5


def test_relu_loose():
    jm, tm, p, x = _pair(activation="ReLU")
    gyw = np.random.default_rng(2).standard_normal((x.shape[0], 16)).astype(np.float32)
    jg, jx = _jax_first_order(jm, p, x, jnp.asarray(gyw))
    pg, px = _port_first_order(tm, p, x, gyw)
    assert _rel(pg, jg) < 0.2 and _rel(px, jx) < 0.2


def test_twin_is_what_the_route_runs():
    """model.apply(prepare_input_gradients=True) takes FusedApplyIgFn, whose
    backward returns `fused_ig_grads` (K9's twin on the CPU) exactly."""
    _, tm, p, x = _pair()
    params = tt.params_from_jax(p, tm.n_params)
    gy = torch.from_numpy(np.random.default_rng(3).standard_normal((x.shape[0], 16))
                          .astype(np.float32)).to(torch.bfloat16).float()
    pr = params.clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm.apply(pr, xt, prepare_input_gradients=True)
    assert out.grad_fn.name() == "FusedApplyIgFnBackward"
    got = torch.autograd.grad(out, (pr, xt), grad_outputs=gy.to(torch.bfloat16))
    want = train_kernel.fused_ig_grads(tm, params, torch.from_numpy(x), gy)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    composed = tm.apply(pr, xt, prepare_input_gradients=True, _no_fused_ig=True)
    assert composed.grad_fn.name() != "FusedApplyIgFnBackward"
    torch.testing.assert_close(composed, out, rtol=0, atol=2.0**-6 * float(out.detach().abs().max()))


@pytest.mark.parametrize("change", [
    {}, {"fast_input_grads": False}, {"interpolation": "Nearest"},
    {"stochastic_interpolation": True}, {"max_level": 0.5}, {"activation": "Sine"},
    {"network": "CutlassMLP"},
])
def test_supported_ig_matches_jax(change):
    change = dict(change)
    enc, net = _cfgs(activation=change.pop("activation", "Sigmoid"))
    if change.pop("network", None):
        net = {**net, "otype": "CutlassMLP"}
    max_level = change.pop("max_level", None)
    enc.update(change)
    jm = tc.create_network_with_input_encoding(3, 1, enc, net)
    tm = tt.create_network_with_input_encoding(3, 1, enc, net)
    jm.encoding.max_level = tm.encoding.max_level = max_level
    assert train_kernel.supported_ig(tm) == jax_supported_ig(jm)


def test_second_order_matches_fib_bwd(monkeypatch):
    """Eikonal-style d/dparams of sum((dy/dx)^2) through the fused route:
    the outer derivative runs the composed fallback (`_fib_bwd` in JAX,
    FusedIgBackwardFn.backward here). The JAX package's composed route
    takes its Pallas kernels only on a TPU backend (simulated, as
    tests/test_fused_ig.py does); on the CPU it would take XLA's f32
    table."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jm, tm, p, x = _pair(b=128, seed=4)

    def eik_jax(pp):
        gx = jax.grad(lambda xx: jnp.sum(fused_apply_ig(jm, pp, xx).astype(F32)))(jnp.asarray(x))
        return jnp.sum(gx * gx)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(eik_jax)(jnp.asarray(p))
    params = tt.params_from_jax(p, tm.n_params).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm.apply(params, xt, prepare_input_gradients=True)
    (gx,) = torch.autograd.grad(out.float().sum(), xt, create_graph=True)
    (got,) = torch.autograd.grad((gx * gx).sum(), params)
    n_net = tm.network.n_params
    assert _rel(got[n_net:], want[n_net:]) < 1e-3
    assert _rel(got[:n_net], want[:n_net]) < 5e-3


def test_fused_and_composed_second_order_agree():
    """The port's two routes on one eikonal gradient: the fused route's
    first order keeps g in f32 (K9), the composed route rounds it to bf16
    per layer (the matmul chain under autograd)."""
    _, tm, p, x = _pair(b=128, seed=5, interp="Smoothstep", n_dims=3)
    grads = []
    for no_fused in (False, True):
        params = tt.params_from_jax(p, tm.n_params).requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        out = tm.apply(params, xt, prepare_input_gradients=True, _no_fused_ig=no_fused)
        (gx,) = torch.autograd.grad(out.float().sum(), xt, create_graph=True)
        grads.append(torch.autograd.grad(((gx.norm(dim=-1) - 1) ** 2).mean(), params)[0])
    assert _rel(grads[0], grads[1]) < 1e-2  # measured 4.0e-3


def test_fused_ig_grads_checks_gy():
    _, tm, p, x = _pair()
    params = tt.params_from_jax(p, tm.n_params)
    with pytest.raises(ValueError, match="gy must be"):
        train_kernel.fused_ig_grads(tm, params, torch.from_numpy(x), torch.zeros(4, 16))
    assert train_kernel.ig_tile(tm) == 128
