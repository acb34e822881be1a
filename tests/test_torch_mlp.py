"""Parity of the port's MLPs (tcnn_tpu_torch.models.mlp and
ops/cuda/mlp_kernel.py) with the JAX package on the CPU, where
FullyFusedMLP runs kernel K2's plain twin.

Tolerance: one bf16 ulp of the output's largest magnitude (2^-7 * max|y|).
Both sides multiply bf16 operands exactly in f32 and round each layer to
bf16, but sum the products in another order, which can flip one rounding.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu.models.mlp import CutlassMLP as JaxCutlass
from tcnn_tpu.models.mlp import FullyFusedMLP as JaxFused
from tcnn_tpu.ops.pallas.mlp_kernel import fused_mlp_apply
from tcnn_tpu_torch.common import Activation, parse_activation
from tcnn_tpu_torch.ops.cuda import mlp_kernel
from tcnn_tpu_torch.utils import profiling


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-7 * max(1e-30, np.abs(want).max()))


def _data(n_params, in_w, width, seed, batch=300):
    rng = np.random.default_rng(seed)
    p = (rng.uniform(-1, 1, n_params) * math.sqrt(3.0 / width)).astype(np.float32)
    x = rng.uniform(-1, 1, (batch, in_w)).astype(np.float32)
    return p, x


def _fused_pair(width, act, out_act, in_w=32, n_out=3, n_hidden=2):
    ja = tc.common.parse_activation(act), tc.common.parse_activation(out_act)
    ta = parse_activation(act), parse_activation(out_act)
    return (JaxFused(in_w, n_out, width, n_hidden, *ja),
            tt.FullyFusedMLP(in_w, n_out, width, n_hidden, *ta))


def _check_fused(width, act, out_act, seed, n_hidden=2):
    jm, tm = _fused_pair(width, act, out_act, n_hidden=n_hidden)
    assert tm.layer_sizes() == jm.layer_sizes() and tm.n_params == jm.n_params
    p, x = _data(jm.n_params, 32, width, seed)
    with pltpu.force_tpu_interpret_mode():
        want = fused_mlp_apply(jm, jnp.asarray(p), jnp.asarray(x))
    got = tm.apply(torch.from_numpy(p), torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (300, 16)
    _close(got.float(), want.astype(jnp.float32))


@pytest.mark.parametrize("width", [16, 32, 64, 128])
def test_plain_mlp_matches_pallas_width(width):
    _check_fused(width, "ReLU", "None", seed=width)


# every activation except Sine as the hidden activation, with the output
# activation cycling through them too
_ACTS = ["None", "ReLU", "LeakyReLU", "Exponential", "Sigmoid", "Squareplus", "Softplus", "Tanh"]


@pytest.mark.parametrize("i", range(len(_ACTS)))
def test_plain_mlp_matches_pallas_activation(i):
    _check_fused(64, _ACTS[i], _ACTS[(i + 3) % len(_ACTS)], seed=100 + i)


def test_plain_mlp_matches_pallas_128x5():
    _check_fused(128, "ReLU", "None", seed=5, n_hidden=5)


@pytest.mark.parametrize(
    "width,n_hidden,act",
    [(48, 0, "ReLU"), (48, 3, "Tanh"), (64, 2, "Sine"), (24, 1, "Softplus")],
)
def test_cutlass_chain_matches_jax(width, n_hidden, act):
    pa = tc.common.parse_activation(act)
    jm = JaxCutlass(40, 5, width, n_hidden, pa, tc.common.Activation.NONE)
    tm = tt.CutlassMLP(40, 5, width, n_hidden, parse_activation(act), Activation.NONE)
    assert tm.layer_sizes() == jm.layer_sizes()
    p, x = _data(jm.n_params, 40, width, seed=width + n_hidden)
    want = jm.apply(jnp.asarray(p), jnp.asarray(x))
    got = tm.apply(torch.from_numpy(p), torch.from_numpy(x))
    _close(got.float(), np.asarray(want.astype(jnp.float32)))


def test_fused_sine_takes_the_matmul_chain():
    fused = tt.FullyFusedMLP(32, 3, 64, 2, Activation.Sine)
    chain = tt.CutlassMLP(32, 3, 64, 2, Activation.Sine)
    p = fused.init_params(torch.Generator().manual_seed(0))
    x = torch.rand(50, 32)
    before = profiling.counts("launches.")
    assert torch.equal(fused.apply(p, x), chain.apply(p, x))
    assert profiling.counts("launches.") == before
    with pytest.raises(ValueError, match="Sine"):
        fused.dims.check_fused()


def test_init_distribution():
    for act, first in ((Activation.ReLU, None), (Activation.Sine, 30.0 / 32)):
        m = tt.FullyFusedMLP(32, 3, 64, 2, act)
        p = m.init_params(torch.Generator().manual_seed(1))
        assert p.dtype == torch.float32 and p.numel() == m.n_params
        off = 0
        for i, (r, c) in enumerate(m.layer_sizes()):
            w = p[off : off + r * c]
            off += r * c
            if act == Activation.Sine:
                bound = first if i == 0 else math.sqrt(6.0 / c)
            else:
                bound = math.sqrt(6.0 / (r + c))
            assert float(w.abs().max()) <= bound
            assert float(w.abs().max()) > 0.9 * bound  # uses the whole range


def test_fused_shape_errors():
    with pytest.raises(ValueError, match="CutlassMLP"):
        tt.FullyFusedMLP(32, 3, 48, 2)
    with pytest.raises(ValueError, match="hidden"):
        tt.FullyFusedMLP(32, 3, 64, 0)
    dims = mlp_kernel.MlpDims(24, 64, 2, 16, Activation.ReLU, Activation.NONE)
    with pytest.raises(ValueError, match="multiples of 16"):
        dims.check_fused()
    good = tt.FullyFusedMLP(32, 3, 64, 2).dims
    with pytest.raises(ValueError, match="bfloat16"):
        mlp_kernel.mlp_forward(good, torch.zeros(good.n_weights), torch.zeros(4, 32, dtype=torch.bfloat16))
