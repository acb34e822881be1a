"""The port's grid backward (kernel K4's plain twin,
tcnn_tpu_torch/ops/cuda/grid_kernel.py) and `GridEncodeFn` against
`jax.vjp` of tcnn_tpu's Pallas grid encoding (interpret mode), on the CPU.

Tolerance: both round each corner contribution w * gy to bf16 and sum the
contributions in f32, in another order; the corner weights are formed in
another order too (the Pallas kernel as (1-w) + bit*(2w-1)), which can move
a weight by one f32 ulp and flip one contribution's bf16 rounding. Allowed:
rtol 1e-5 (f32 summation order) plus one bf16 ulp of the largest single
contribution (2^-8 * max|gy|) per table value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu.ops.pallas import grid_kernel as jax_grid_kernel
from tcnn_tpu_torch.ops.cuda import grid_kernel


def _enc_cfg(**kw):
    cfg = {
        "otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
        "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 2.0,
    }
    cfg.update(kw)
    return cfg


def _inputs(d, cfg, seed, batch=300):
    je, te = tc.create_encoding(d, cfg), tt.create_encoding(d, cfg)
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, je.n_params).astype(np.float32)
    x = rng.uniform(-0.2, 1.2, (batch, d)).astype(np.float32)  # also outside [0, 1]
    gy = rng.normal(size=(batch, te.n_output_dims)).astype(np.float32)
    gy = np.asarray(jnp.asarray(gy).astype(jnp.bfloat16).astype(jnp.float32))  # bf16 values
    return je, te, p, x.copy(), gy.copy()


def _close(got, want, gy):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2.0**-8 * np.abs(gy).max())


def _jax_grad(je, p, x, gy, max_level=None):
    """jax.vjp of tcnn_tpu's Pallas encoding (grid_encode_pallas, plus the
    max_level mask applied after it, grid.py:337-343)."""
    def f(q):
        return je.apply_unpadded(q, jnp.asarray(x), max_level=max_level, impl="pallas",
                                 needs_input_grad=False)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, jnp.asarray(p))
        (g,) = vjp(jnp.asarray(gy).astype(jnp.bfloat16))
    return np.asarray(g)


def _jax_bwd(je, x, gy):
    """The backward half of that vjp alone: `_grid_pallas_bwd`, the custom
    vjp's rule that runs the TPU kernel `_bwd_kernel` (skips compiling the
    forward in interpret mode)."""
    plan = jax_grid_kernel.plan_for(je)
    nt = plan.batch_tile
    pad = -(-x.shape[0] // nt) * nt - x.shape[0]
    xp = jnp.pad(jnp.asarray(x), ((0, pad), (0, 0)))
    gyp = jnp.pad(jnp.asarray(gy).astype(jnp.bfloat16), ((0, pad), (0, 0)))
    with pltpu.force_tpu_interpret_mode():
        g, _, _ = jax_grid_kernel._grid_pallas_bwd(plan, je.n_params, (xp, jnp.zeros((1, 1))), gyp)
    return np.asarray(g)


# every grid type with every interpolation; D in {2, 3} and F in {1, 2, 4,
# 8} each run (a covering set keeps the interpret-mode kernels quick; F = 8
# is K4's two-float4 row and its private levels' 32-byte rows)
_CASES = [
    ("Hash", "Linear", 2, 2),
    ("Hash", "Linear", 2, 8),
    ("Hash", "Smoothstep", 3, 1),
    ("Hash", "Nearest", 2, 4),
    ("Dense", "Linear", 3, 4),
    ("Dense", "Smoothstep", 2, 2),
    ("Dense", "Nearest", 3, 1),
    ("Tiled", "Linear", 2, 1),
    ("Tiled", "Smoothstep", 3, 2),
    ("Tiled", "Nearest", 2, 4),
]


@pytest.mark.parametrize("grid_type,interp,d,f", _CASES)
def test_table_gradient_matches_pallas_vjp(grid_type, interp, d, f):
    cfg = _enc_cfg(type=grid_type, interpolation=interp, n_features_per_level=f)
    je, te, p, x, gy = _inputs(d, cfg, seed=10 * d + f)
    want = _jax_bwd(je, x, gy)
    got = grid_kernel._grid_backward_plain(
        te.plan, torch.from_numpy(x), torch.from_numpy(gy), te.n_levels)
    assert got.dtype == torch.float32 and tuple(got.shape) == (te.plan.total_rows, f)
    _close(got.reshape(-1).numpy(), want, gy)
    # through autograd: GridEncodeFn returns the same f32 gradient
    params = torch.from_numpy(p).requires_grad_(True)
    y = te.apply_unpadded(params, torch.from_numpy(x))
    y.backward(torch.from_numpy(gy).to(torch.bfloat16))
    assert params.grad.dtype == torch.float32
    assert torch.equal(params.grad, got.reshape(-1))


def test_max_level_gradient():
    cfg = _enc_cfg(n_levels=6)
    je, te, p, x, gy = _inputs(2, cfg, seed=5)
    want = _jax_grad(je, p, x, gy, max_level=0.5)
    for max_level in (0.5, 0.0):
        params = torch.from_numpy(p).requires_grad_(True)
        te.apply_unpadded(params, torch.from_numpy(x), max_level=max_level).backward(
            torch.from_numpy(gy).to(torch.bfloat16))
        n_active = te.active_levels(max_level)
        off = int(te._offsets[n_active]) * te.n_features_per_level
        assert not params.grad[off:].any()  # levels past max_level get nothing
    assert n_active == 1  # level 0 is always kept (0 < 0 * L + 1e-3)
    params = torch.from_numpy(p).requires_grad_(True)
    te.update_hyperparams({"max_level": 0.5})
    te.apply_unpadded(params, torch.from_numpy(x)).backward(torch.from_numpy(gy).to(torch.bfloat16))
    _close(params.grad.numpy(), want, gy)


def test_padded_output_gradient_ignores_padding():
    te = tt.create_encoding(2, _enc_cfg(n_levels=3))
    te.set_alignment(16)
    params = (torch.rand(te.n_params) * 2 - 1).requires_grad_(True)
    x = torch.rand(40, 2)
    gy = torch.randn(40, 16).to(torch.bfloat16)
    te.apply(params, x).backward(gy)
    want = grid_kernel._grid_backward_plain(te.plan, x, gy[:, :6], te.n_levels)
    assert torch.equal(params.grad, want.reshape(-1))


def test_input_gradient_and_stochastic_backward_raise():
    """An x that requires a gradient still raises; the stochastic backward,
    once refused, now runs K4's stochastic option (its twin here): each
    (sample, level) row goes whole to one corner
    (tests/test_torch_stochastic.py holds it against tcnn_tpu)."""
    te = tt.create_encoding(2, _enc_cfg())
    params = torch.zeros(te.n_params, requires_grad=True)
    with pytest.raises(NotImplementedError, match="prepare_input_gradients=True"):
        te.apply(params, torch.rand(8, 2, requires_grad=True))
    st = tt.create_encoding(2, _enc_cfg(stochastic_interpolation=True))
    sp = torch.zeros(st.n_params, requires_grad=True)
    x = torch.rand(8, 2)
    st.apply(sp, x).float().sum().backward()
    want = grid_kernel._grid_backward_stoch_plain(st.plan, x, torch.ones(8, st.n_output_dims),
                                                  st.n_levels)
    assert torch.equal(sp.grad, want.reshape(-1))
    assert float(sp.grad.sum()) == 8 * st.n_output_dims  # weight 1 per (sample, level, feature)


def test_backward_checks_shapes():
    te = tt.create_encoding(2, _enc_cfg())
    with pytest.raises(ValueError, match="gy must be"):
        grid_kernel.grid_backward(te.plan, torch.rand(5, 2), torch.zeros(4, 8), te.n_levels)
