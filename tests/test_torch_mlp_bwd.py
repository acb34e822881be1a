"""The port's MLP backward (kernel K5's plain twin,
tcnn_tpu_torch/ops/cuda/mlp_kernel.py) and `FusedMlpFn` against tcnn_tpu's
Pallas MLP backward (interpret mode), and the CutlassMLP chain's autograd
against `jax.grad`, on the CPU.

Tolerance: norm-relative error below 2^-9 for gW and gx, and gx within
one bf16 ulp of its largest magnitude (2^-7 * max|gx|) element by element.
Both sides round g to bf16 at every layer and multiply exactly in f32, but
sum in another order, which can flip a bf16 rounding of g by 2^-8 of its
value; the flips spread through the later layers' sums. Measured: at most
1.7e-4 norm-relative (128x5), most cases below 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu.models.mlp import CutlassMLP as JaxCutlass
from tcnn_tpu.models.mlp import FullyFusedMLP as JaxFused
from tcnn_tpu.ops.pallas import mlp_kernel as jax_mlp_kernel
from tcnn_tpu_torch.common import Activation, parse_activation
from tcnn_tpu_torch.ops.cuda import mlp_kernel


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _data(n_params, in_w, out_w, width, seed, batch=300):
    rng = np.random.default_rng(seed)
    p = (rng.uniform(-1, 1, n_params) * math.sqrt(3.0 / width)).astype(np.float32)
    x = rng.uniform(-1, 1, (batch, in_w)).astype(np.float32)
    gy = rng.normal(size=(batch, out_w)).astype(np.float32)
    return p, x, gy


def _jax_bwd(jm, p, x, gy):
    """tcnn_tpu's custom-vjp backward rule `_fused_mlp_bwd`, which runs the
    TPU kernel `_bwd_kernel` (called directly: the forward's interpret-mode
    compile is not needed), on the batch padded to its tile."""
    nt = jax_mlp_kernel.DEFAULT_BATCH_TILE
    pad = -(-x.shape[0] // nt) * nt - x.shape[0]
    xb = jnp.pad(jnp.asarray(x).astype(jnp.bfloat16), ((0, pad), (0, 0)))
    gyb = jnp.pad(jnp.asarray(gy).astype(jnp.bfloat16), ((0, pad), (0, 0)))
    with pltpu.force_tpu_interpret_mode():
        gp, gx = jax_mlp_kernel._fused_mlp_bwd(jm, (jnp.asarray(p), xb), gyb)
    return np.asarray(gp), np.asarray(gx[: x.shape[0]].astype(jnp.float32))


# every activation but Sine as the hidden and as the output activation,
# across the four fused widths
_CASES = [
    (16, "ReLU", "None"),
    (32, "LeakyReLU", "Sigmoid"),
    (64, "Exponential", "Squareplus"),
    (128, "Softplus", "Tanh"),
    (64, "Tanh", "LeakyReLU"),
    (32, "Sigmoid", "Softplus"),
    (16, "Squareplus", "Exponential"),
    (64, "None", "ReLU"),
]


@pytest.mark.parametrize("width,act,out_act", _CASES)
def test_plain_backward_matches_pallas(width, act, out_act):
    jm = JaxFused(32, 3, width, 2, tc.common.parse_activation(act),
                  tc.common.parse_activation(out_act))
    tm = tt.FullyFusedMLP(32, 3, width, 2, parse_activation(act), parse_activation(out_act))
    p, x, gy = _data(jm.n_params, 32, 16, width, seed=width)
    want_gw, want_gx = _jax_bwd(jm, p, x, gy)
    dims = tm.dims
    gw, gx = mlp_kernel._mlp_backward_plain(
        dims, torch.from_numpy(p).to(torch.bfloat16), torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(gy).to(torch.bfloat16))
    assert gw.dtype == torch.float32 and tuple(gw.shape) == (dims.n_weights,)
    assert gx.dtype == torch.bfloat16 and tuple(gx.shape) == (300, 32)
    assert _rel(gw, want_gw) < 2.0**-9, _rel(gw, want_gw)
    assert _rel(gx.float(), want_gx) < 2.0**-9, _rel(gx.float(), want_gx)
    np.testing.assert_allclose(gx.float().numpy(), want_gx, rtol=0,
                               atol=2.0**-7 * np.abs(want_gx).max())
    # through autograd: FusedMlpFn returns the same gradients, gW in f32
    params = torch.from_numpy(p).requires_grad_(True)
    xin = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tm.apply(params, xin).backward(torch.from_numpy(gy).to(torch.bfloat16))
    assert params.grad.dtype == torch.float32 and torch.equal(params.grad, gw)
    assert torch.equal(xin.grad, gx)


def test_plain_backward_128x5():
    jm = JaxFused(32, 3, 128, 5)
    tm = tt.FullyFusedMLP(32, 3, 128, 5)
    p, x, gy = _data(jm.n_params, 32, 16, 128, seed=5)
    want_gw, want_gx = _jax_bwd(jm, p, x, gy)
    gw, gx = mlp_kernel._mlp_backward_plain(
        tm.dims, torch.from_numpy(p).to(torch.bfloat16), torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(gy).to(torch.bfloat16))
    assert _rel(gw, want_gw) < 2.0**-9 and _rel(gx.float(), want_gx) < 2.0**-9


@pytest.mark.parametrize("width,n_hidden,act", [(48, 0, "ReLU"), (24, 2, "Tanh"), (64, 2, "Sine")])
def test_cutlass_chain_autograd_matches_jax_grad(width, n_hidden, act):
    """The matmul chain differentiated by torch autograd against jax.grad
    through tcnn_tpu's XLA chain: both round the same values to bf16 in
    forward and backward; allowed, norm-relative 2^-6 (summation order)."""
    pa = tc.common.parse_activation(act)
    jm = JaxCutlass(40, 5, width, n_hidden, pa, tc.common.Activation.NONE)
    tm = tt.CutlassMLP(40, 5, width, n_hidden, parse_activation(act), Activation.NONE)
    p, x, gy = _data(jm.n_params, 40, 16, width, seed=width + n_hidden)
    _, vjp = jax.vjp(lambda q, xx: jm.apply(q, xx), jnp.asarray(p), jnp.asarray(x))
    want_gp, want_gx = vjp(jnp.asarray(gy).astype(jnp.bfloat16))
    params = torch.from_numpy(p).requires_grad_(True)
    xin = torch.from_numpy(x).requires_grad_(True)
    tm.apply(params, xin).backward(torch.from_numpy(gy).to(torch.bfloat16))
    assert _rel(params.grad, np.asarray(want_gp)) < 2.0**-6
    assert _rel(xin.grad, np.asarray(want_gx)) < 2.0**-6


def test_backward_checks_shapes():
    dims = tt.FullyFusedMLP(32, 3, 64, 2).dims
    w = torch.zeros(dims.n_weights, dtype=torch.bfloat16)
    x = torch.zeros(4, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="gy must be"):
        mlp_kernel.mlp_backward(dims, w, x, torch.zeros(4, 8, dtype=torch.bfloat16))
