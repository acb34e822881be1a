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
from tcnn_tpu_torch.ops.activations import activation_bwd_out
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


def _split_backward_emulated(dims, weights, x, gy, grid, g_in_bf16=True):
    """K5's split plan (csrc/mlp_bwd_split.cu) on the CPU, f64 products and
    f32 sums where the card sums in f32. mlp_dgrad_kernel: each 16-row tile
    through the forward keeping h_1..h_H (bf16), then G_H = bf16(out_act'(gy))
    and G_{i-1} = bf16(act'(G_i W_i)), every G_i kept (in f32 instead of
    bf16 with `g_in_bf16` False: the control), dL/dinput = bf16(G_0 W_0).
    mlp_wgrad_kernel: block b of `grid` owns rows [b R, (b + 1) R), R =
    ceil(B / grid), in chunks of WGRAD_ROWS whose rows past the slice are
    zero; each 16-row step adds G_i^T h_i into f32 accumulators, and the
    block writes its partial once. reduce_partials adds the partials in
    block order, in f32. Returns (gW f32 [n_weights], gx bf16)."""
    mats = mlp_kernel._weights(dims, weights)
    B, H = x.shape[0], dims.n_hidden
    hs = [np.zeros((B, c), np.float64) for _, c in dims.layer_sizes()]
    gs = [np.zeros((B, r), np.float64) for r, _ in dims.layer_sizes()]
    gx = torch.empty(B, dims.in_w, dtype=torch.bfloat16)
    for r0 in range(0, B, 16):
        rows = slice(r0, min(B, r0 + 16))
        keep = mlp_kernel._forward_keep(dims, mats, x[rows])
        g = gy[rows].float()
        for i in range(H, -1, -1):
            act = dims.output_activation if i == H else dims.activation
            g = activation_bwd_out(g, keep[i + 1], act)
            g = g.to(torch.bfloat16).float() if g_in_bf16 else g
            gs[i][rows], hs[i][rows] = g.double().numpy(), keep[i].double().numpy()
            g = g @ mats[i]
        gx[rows] = g.to(torch.bfloat16)
    per_block = -(-B // grid)
    partials = np.zeros((grid, dims.n_weights), np.float32)
    for b in range(grid):
        lo, hi = b * per_block, min(B, (b + 1) * per_block)
        flat = []
        for i in range(H + 1):
            acc = np.zeros(dims.layer_sizes()[i], np.float32)
            for c0 in range(lo, hi, mlp_kernel.WGRAD_ROWS):
                live = min(mlp_kernel.WGRAD_ROWS, hi - c0)
                for r in range(0, live, 16):  # the last step's rows past the slice are zeros
                    sl = slice(c0 + r, min(c0 + r + 16, hi))
                    acc = (acc + gs[i][sl].T @ hs[i][sl]).astype(np.float32)
            flat.append(acc.reshape(-1))
        partials[b] = np.concatenate(flat)
    gw = np.zeros(dims.n_weights, np.float32)
    for b in range(grid):
        gw = (gw + partials[b]).astype(np.float32)
    return torch.from_numpy(gw), gx


@pytest.mark.parametrize("act", ["ReLU", "Tanh"])
def test_split_backward_emulated_matches_the_plain_twin(act):
    """K5's split plan at config_oneblob's shape (input 128, 128 x 5, 16
    out) on a ragged batch (987 rows over 8 blocks of 124: the last block
    119, each slice's last chunk short) against `_mlp_backward_plain`:
    the same bf16 roundings, so gW differs only in the f32 summation order
    (measured 9.3e-8 to 9.6e-8 norm-relative under ReLU, 1.2e-7 to 1.3e-7
    under Tanh, seeds 24-26; allowed 1e-5) and dL/dinput not at all. The
    control, G kept in f32 between layers (no bf16 rounding), reads 2.3e-3
    to 2.9e-3 and must break the bound."""
    tm = tt.FullyFusedMLP(128, 16, 128, 5, parse_activation(act), Activation.NONE)
    dims = tm.dims
    assert mlp_kernel.mlp_bwd_plan(dims) == "split"
    p, x, gy = _data(tm.n_params, 128, 16, 128, seed=24, batch=987)
    w = torch.from_numpy(p).to(torch.bfloat16)
    xb, gyb = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(gy).to(torch.bfloat16)
    want_gw, want_gx = mlp_kernel._mlp_backward_plain(dims, w, xb, gyb)
    gw, gx = _split_backward_emulated(dims, w, xb, gyb, grid=8)
    assert _rel(gw, want_gw) < 1e-5, _rel(gw, want_gw)
    assert torch.equal(gx, want_gx)
    gw, _ = _split_backward_emulated(dims, w, xb, gyb, grid=8, g_in_bf16=False)
    assert _rel(gw, want_gw) > 1e-5, _rel(gw, want_gw)


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
