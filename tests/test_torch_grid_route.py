"""The grid's plain differentiable route (GridEncoding.interpolate_f32 and
_StochasticGridFn, tcnn_tpu_torch/ops/encodings/grid.py) against tcnn_tpu's
XLA autodiff route on the CPU: `_apply_xla` (grid.py:393-443) and
`_apply_stochastic` (grid.py:476-529), through `jax.vjp`, `jax.grad` and
`jax.hessian`. The route serves the input-gradient cases the kernels leave
out - Nearest, stochastic interpolation, a scalar or per-sample max_level,
`"fast_input_grads": false` - and every case at compute dtype f32 on a CPU
tensor.

Bounds: both evaluate the same f32 expressions from the f32 table in the
same corner order, so the forward agrees with tcnn_tpu's, run op by op, to
the last f32 bit (measured 0; held at rtol 1e-6) and bit for bit at bf16.
The derivatives run under jax.jit (op by op they take minutes here), whose
fusions round a product or a sum in another order now and then, and they
sum their terms in another order (the scatter, the corner sum): held at
rtol 1e-5 with an absolute floor of 1e-6 of the largest value (measured:
no difference above 3.7e-6 of the largest value). The stochastic table gradient is held
exactly: both add each (sample, level)'s f32 row into the row its draw
chose, in sample order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu_torch.ops.cuda import grid_kernel

B = 40


def _enc_cfg(**kw):
    cfg = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
           "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 1.6}
    cfg.update(kw)
    return cfg


def _per_sample(rng):
    return rng.uniform(0.0, 1.0, B).astype(np.float32)


#: (id, dims, encoding keys, max_level: None, a float or "per-sample")
CASES = [
    ("fast_input_grads=false", 2, {"fast_input_grads": False}, None),
    ("smoothstep 3-D", 3, {"interpolation": "Smoothstep", "fast_input_grads": False}, None),
    ("Nearest", 2, {"interpolation": "Nearest"}, None),
    ("max_level", 2, {}, 0.5),
    ("per-sample max_level", 3, {}, "per-sample"),
    ("stochastic", 2, {"stochastic_interpolation": True}, None),
    ("stochastic max_level", 3, {"stochastic_interpolation": True}, 0.6),
    ("Rng dense", 2, {"hash": "Rng", "type": "Dense", "fast_input_grads": False}, None),
]


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    floor = 1e-6 * max(np.abs(want).max(initial=0.0), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


def _setup(d, enc, ml, seed):
    cfg = _enc_cfg(**enc)
    je, te = tc.create_encoding(d, cfg), tt.create_encoding(d, cfg)
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, je.n_params).astype(np.float32)
    x = rng.uniform(-0.1, 1.1, (B, d)).astype(np.float32)
    ml = _per_sample(rng) if ml == "per-sample" else ml
    gy = rng.normal(size=(B, te.n_output_dims)).astype(np.float32)
    z = rng.normal(size=(B, d)).astype(np.float32)
    return je, te, p, x, ml, gy, z


def _jax_fn(je, ml, dtype):
    def f(p, x):
        return je.apply_unpadded(p, x, compute_dtype=dtype, max_level=ml,
                                 needs_input_grad=True).astype(jnp.float32)
    return f


def _port_fn(te, ml, dtype):
    tml = None if ml is None or np.ndim(ml) == 0 else torch.from_numpy(ml)
    tml = ml if tml is None else tml

    def f(p, x):
        return te.apply_unpadded(p, x, max_level=tml, needs_input_grad=True,
                                 compute_dtype=dtype).float()
    return f


def _t(a, grad=True):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_and_first_order(case, dtype):
    _, d, enc, ml = case
    je, te, p, x, ml, gy, _ = _setup(d, enc, ml, seed=1)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)

    @jax.jit
    def jvjp(p, x, gy):
        return jax.vjp(_jax_fn(je, ml, jd), p, x)[1](gy)

    y = _jax_fn(je, ml, jd)(jnp.asarray(p), jnp.asarray(x))
    gp, gx = jvjp(jnp.asarray(p), jnp.asarray(x), jnp.asarray(gy))
    pt, xt = _t(p), _t(x)
    yt = _port_fn(te, ml, td)(pt, xt)
    gpt, gxt = torch.autograd.grad(yt, (pt, xt), torch.from_numpy(gy))
    if dtype == "bf16":
        np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
    else:
        np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), rtol=1e-6, atol=1e-7)
    if case[0] == "stochastic":
        np.testing.assert_array_equal(gpt.numpy(), np.asarray(gp))
    else:
        _close(gpt.numpy(), gp)
    _close(gxt.numpy(), gx)
    if enc.get("interpolation") == "Nearest":
        assert not gxt.any() and not np.asarray(gx).any()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_second_order(case):
    """d/dp and d/dx of z . dL/dx, L = gy . y: the eikonal term's second
    order, against the VJP of jax.grad."""
    _, d, enc, ml = case
    je, te, p, x, ml, gy, z = _setup(d, enc, ml, seed=2)
    jf = _jax_fn(je, ml, jnp.float32)

    def jgx(p, x):
        return jax.grad(lambda xx: jnp.sum(jf(p, xx) * gy))(x)

    @jax.jit
    def jvjp(p, x, z):
        gx, vjp = jax.vjp(jgx, p, x)
        return (gx,) + vjp(z)

    gx, cp, cx = jvjp(jnp.asarray(p), jnp.asarray(x), jnp.asarray(z))
    pt, xt = _t(p), _t(x)
    yt = _port_fn(te, ml, torch.float32)(pt, xt)
    (gxt,) = torch.autograd.grad((yt * torch.from_numpy(gy)).sum(), xt, create_graph=True)
    _close(gxt.detach().numpy(), gx)
    cpt, cxt = torch.autograd.grad((gxt * torch.from_numpy(z)).sum(), (pt, xt),
                                   allow_unused=True)
    _close(cpt.numpy(), cp)
    _close(torch.zeros_like(xt) if cxt is None else cxt.numpy(), cx)


@pytest.mark.parametrize("interpolation", ["Linear", "Smoothstep"])
def test_hessian_in_x(interpolation):
    je, te, p, x, ml, gy, _ = _setup(2, {"interpolation": interpolation,
                                         "fast_input_grads": False}, None, seed=3)
    x, gy = x[:12], gy[:12]
    jf = _jax_fn(je, None, jnp.float32)
    want = jax.jit(jax.hessian(lambda xx: jnp.sum(jf(jnp.asarray(p), xx) * gy)))(jnp.asarray(x))
    pt = _t(p, grad=False)
    got = torch.autograd.functional.hessian(
        lambda xx: (_port_fn(te, None, torch.float32)(pt, xx) * torch.from_numpy(gy)).sum(),
        _t(x, grad=False))
    _close(got.numpy(), want)


@pytest.mark.parametrize("interpolation", ["Linear", "Smoothstep"])
def test_third_order_without_fast_input_grads(interpolation):
    """d/dx of sum(d/dp ||dL/dx||^2): a third derivative, which the kernel
    path refuses (tests/test_torch_grid_ig.py) and this route takes."""
    je, te, p, x, _, gy, _ = _setup(2, {"interpolation": interpolation,
                                        "fast_input_grads": False}, None, seed=4)
    jf = _jax_fn(je, None, jnp.float32)

    def g2(p, x):
        def eik(pp):
            return jnp.sum(jax.grad(lambda xx: jnp.sum(jf(pp, xx) * gy))(x) ** 2)
        return jnp.sum(jax.grad(eik)(p) ** 2)

    want_p, want_x = jax.jit(jax.grad(g2, argnums=(0, 1)))(jnp.asarray(p), jnp.asarray(x))
    pt, xt = _t(p), _t(x)
    yt = _port_fn(te, None, torch.float32)(pt, xt)
    (gxt,) = torch.autograd.grad((yt * torch.from_numpy(gy)).sum(), xt, create_graph=True)
    (gpt,) = torch.autograd.grad((gxt**2).sum(), pt, create_graph=True)
    got_p, got_x = torch.autograd.grad((gpt**2).sum(), (pt, xt))
    _close(got_p.numpy(), want_p)
    _close(got_x.numpy(), want_x)


def test_stochastic_rows_are_tcnn_tpus():
    je, te, p, x, _, _, _ = _setup(3, {"stochastic_interpolation": True,
                                       "interpolation": "Smoothstep"}, None, seed=5)
    rows = grid_kernel.stochastic_rows(te.plan, torch.from_numpy(x))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(je._stochastic_corner_rows(x)))


def test_stochastic_without_input_gradients_at_f32():
    """At f32 without needs_input_grad the stochastic route gives the one-
    corner table gradient and dL/dx = 0, as `_apply_stochastic(...,
    needs_input_grad=False)` does."""
    je, te, p, x, _, gy, _ = _setup(2, {"stochastic_interpolation": True}, None, seed=6)
    _, vjp = jax.vjp(lambda pp, xx: je._apply_stochastic(pp, xx, jnp.float32, None,
                                                         needs_input_grad=False),
                     jnp.asarray(p), jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(gy))
    pt, xt = _t(p), _t(x)
    yt = te.apply_unpadded(pt, xt, compute_dtype=torch.float32)
    gpt, gxt = torch.autograd.grad(yt, (pt, xt), torch.from_numpy(gy))
    np.testing.assert_array_equal(gpt.numpy(), np.asarray(gp))
    assert not gxt.any() and not np.asarray(gx).any()


def test_kernel_path_keeps_what_it_serves():
    """A Linear grid with fast_input_grads and no max_level keeps K1/K7/K8
    (their twins here); the four refused cases take the plain route."""
    te = tt.create_encoding(2, _enc_cfg())
    x = torch.rand(8, 2, requires_grad=True)
    p = torch.rand(te.n_params, requires_grad=True)
    assert type(te.apply(p, x, needs_input_grad=True).grad_fn).__name__ == "GridIgFnBackward"
    for enc, ml in (({"interpolation": "Nearest"}, None), ({"fast_input_grads": False}, None),
                    ({}, 0.5), ({"stochastic_interpolation": True}, None)):
        e = tt.create_encoding(2, _enc_cfg(**enc))
        name = type(e.apply(p, x, max_level=ml, needs_input_grad=True).grad_fn).__name__
        assert name != "GridIgFnBackward"


@pytest.mark.parametrize("enc,ml", [({"fast_input_grads": False}, None), ({}, 0.5),
                                    ({"stochastic_interpolation": True}, None)],
                         ids=["fast_input_grads=false", "max_level", "stochastic"])
def test_model_eikonal_gradient_matches_tcnn_tpu(enc, ml):
    """A grid + FullyFusedMLP model's eikonal term through the plain route
    and the bf16 matmul chain: its params gradient against tcnn_tpu's XLA
    route. Both chains compute the same bf16-rounded layers from the same
    bf16 encoding; they sum in another order, which can flip a bf16
    rounding: norm-relative 1e-3 (measured at most 2e-6)."""
    cfg = {"loss": {"otype": "L2"}, "optimizer": {"otype": "Adam"},
           "encoding": _enc_cfg(**enc),
           "network": {"otype": "FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 2}}
    jm = tc.create_from_config(3, 1, cfg)
    tm = tt.create_from_config(3, 1, cfg, device="cpu")
    p = np.asarray(jm.trainer.params).copy()
    n_net = jm.network.network.n_params
    p[n_net:] = np.random.default_rng(7).uniform(-1, 1, p.size - n_net)
    x = np.random.default_rng(8).uniform(size=(64, 3)).astype(np.float32)

    def jloss(pp):
        def f(xx):
            return jnp.sum(jm.network.apply(pp, xx, max_level=ml,
                                            prepare_input_gradients=True)[:, 0]
                           .astype(jnp.float32))
        g = jax.grad(f)(jnp.asarray(x))
        return jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    want = jax.jit(jax.grad(jloss))(jnp.asarray(p))
    pt, xt = _t(p), _t(x)
    out = tm.network.apply(pt, xt, max_level=ml, prepare_input_gradients=True)
    (g,) = torch.autograd.grad(out[:, 0].float().sum(), xt, create_graph=True)
    (got,) = torch.autograd.grad(((g.norm(dim=-1) - 1.0) ** 2).mean(), pt)
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-3
