"""Parity of the port's fused grid + MLP inference
(tcnn_tpu_torch/ops/cuda/train_kernel.py) with the JAX package's
`fused_forward` (Pallas, interpret mode) and with the port's own composed
path, on the CPU, where kernel K3 runs its plain twin.

Tolerance against JAX: one bf16 ulp of the output's largest magnitude
(2^-7 * max|y|): the encodings agree to a bf16 ulp (see test_torch_grid.py)
and the MLP sums its products in another order (see test_torch_mlp.py).
Against the composed path: exact, since the plain twins compose.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu.ops.pallas.train_kernel import fused_forward
from tcnn_tpu_torch.ops.cuda import train_kernel


def _config(**enc):
    e = {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
         "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 1.5}
    e.update(enc)
    return {"encoding": e, "network": {"otype": "FullyFusedMLP", "n_neurons": 32,
                                       "n_hidden_layers": 2, "activation": "ReLU"}}


def _models(cfg, d=2, seed=0):
    """Both packages from one config, sharing one flat params vector whose
    table is redrawn from U(-1, 1) (the grid init is 1e-4)."""
    jm = tc.create_from_config(d, 3, cfg)
    tm = tt.create_from_config(d, 3, cfg, device="cpu")
    p = np.asarray(jm.trainer.params).copy()
    n_net = jm.network.network.n_params
    p[n_net:] = np.random.default_rng(seed).uniform(-1, 1, p.size - n_net)
    return jm, tm, p


@pytest.mark.parametrize(
    "enc,d",
    [
        ({}, 2),
        ({"type": "Dense", "interpolation": "Smoothstep", "n_features_per_level": 4}, 3),
        ({"type": "Tiled", "interpolation": "Nearest"}, 2),
        ({"n_features_per_level": 8}, 2),
    ],
)
def test_plain_fused_matches_jax_fused_forward(enc, d):
    jm, tm, p = _models(_config(**enc), d)
    x = np.random.default_rng(1).uniform(0, 1, (333, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused_forward(jm.network, jnp.asarray(p), jnp.asarray(x)), np.float32)
    got = train_kernel.fused_forward(tm.network, torch.from_numpy(p), torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0**-7 * np.abs(want).max())


def test_fused_matches_composed():
    _, tm, p = _models(_config(n_features_per_level=4))
    params = torch.from_numpy(p)
    x = torch.rand(517, 2)
    fused = train_kernel.fused_forward(tm.network, params, x)
    assert torch.equal(fused, tm.network.apply(params, x))


def test_prepared_operands_and_gate():
    _, tm, p = _models(_config())
    params = torch.from_numpy(p)
    prep = train_kernel.prepare_forward(tm.network, params)
    net_p, enc_p = tm.network.split_params(params)
    assert prep.plan is tm.network.encoding.plan
    assert torch.equal(prep.weights, net_p.to(torch.bfloat16))
    assert torch.equal(prep.table.flatten(), enc_p.to(torch.bfloat16))
    assert tuple(prep.table.shape) == (prep.plan.total_rows, 2)
    assert prep.dims.in_w == tm.network.encoding.padded_output_width == 16
    # models that are not grid + FullyFusedMLP without Sine take model.apply
    for net in ({"otype": "CutlassMLP", "n_neurons": 32, "n_hidden_layers": 2},
                {"otype": "FullyFusedMLP", "n_neurons": 32, "n_hidden_layers": 2,
                 "activation": "Sine"}):
        other = tt.create_network_with_input_encoding(2, 3, _config()["encoding"], net)
        assert train_kernel.fused_plan_for(other) is None
        with pytest.raises(ValueError, match="grid"):
            train_kernel.prepare_forward(other, torch.zeros(other.n_params))


def test_inference_cache_follows_in_place_updates():
    _, tm, p = _models(_config())
    tr = tm.trainer
    x = torch.rand(64, 2)
    before = tr.inference(x)
    prep = tr._prepared()
    assert tr._prepared() is prep  # cached while params are unchanged
    tr.set_params(torch.from_numpy(p))  # in place: same tensor, new version
    assert tr._prepared() is not prep
    after = tr.inference(x)
    assert not torch.equal(before, after)
    assert torch.equal(after, tm.network.apply(tr.params, x)[:, :3].float())
