"""The port's eikonal SDF slice with a PPNG encoding
(tcnn_tpu_torch/samples/learn_a_sdf.py with PPNG1/2/3) at a small size on
the CPU, against the same loss in tcnn_tpu (samples/learn_a_sdf.py:72-94)
on its TPU route, simulated: its Pallas kernels (the dense-ext gather and
scatter, the fully fused MLP) in interpret mode. Both read the PPNG tables
in the same precision (bf16 for PPNG2/3, f32 for PPNG1) and run the data
term through the fused MLP and the eikonal term through the encoding into
the MLP's matmul chain.

Tolerances: the loss 1e-5 relative (measured up to 1.6e-7); its parameter
gradient 1e-4 norm-relative (measured up to 5.1e-6, PPNG2): the port rounds
the eikonal second order's gy cotangent of PPNG3 to bf16 where the JAX
dense-ext route keeps f32 (K12's output, as the binned route rounds it),
sums in other orders, and the two frameworks' sin differ by an ulp now and
then.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu_torch.ops.cuda import train_kernel
from tcnn_tpu_torch.samples import learn_a_sdf as sdf

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, N_EIK = 256, 64
SMALL = {"PPNG1": {"n_quants": 16, "n_frequencies": 2, "n_features": 2, "rank": 2},
         "PPNG2": {"n_quants": 16, "n_frequencies": 2, "n_features": 2, "rank": 2},
         "PPNG3": {"n_quants": 16, "n_frequencies": 2, "n_features": 2}}


def _jax_sample():
    spec = importlib.util.spec_from_file_location("jax_learn_a_sdf", ROOT / "samples" / "learn_a_sdf.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config(otype):
    cfg = sdf.config(otype)
    cfg["encoding"].update(SMALL[otype])
    cfg["network"]["n_neurons"] = 16
    return cfg


def _rel(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_sample_configs_are_the_jax_samples():
    jax_encodings = _jax_sample().ENCODINGS
    assert sdf.ENCODINGS == jax_encodings
    for otype in jax_encodings:
        cfg = sdf.config(otype)
        assert cfg["encoding"] == jax_encodings[otype] and cfg["encoding"] is not sdf.ENCODINGS[otype]


@pytest.mark.parametrize("otype", ["PPNG1", "PPNG2", "PPNG3"])
def test_eikonal_loss_and_gradient_match_jax(otype, monkeypatch):
    cfg = _config(otype)
    jm = tc.create_from_config(3, 1, cfg)
    tm = tt.create_from_config(3, 1, cfg, device="cpu")
    assert not train_kernel.supported_ig(tm.network)
    rng = np.random.default_rng(0)
    p = np.asarray(jm.trainer.params).copy()
    n_net = jm.network.network.n_params
    p[n_net:] = rng.uniform(-0.7, 0.7, p.size - n_net)
    tm.trainer.set_params(tt.params_from_jax(p, tm.network.n_params))
    xs = rng.uniform(0, 1, (B, 3)).astype(np.float32)
    sdf_true = _jax_sample().sdf_true

    def jloss(params):
        pts = jnp.asarray(xs)
        out = jm.network.apply(params, pts)[:, :1].astype(jnp.float32)
        data = jnp.mean((out - sdf_true(pts)[:, None]) ** 2)
        g = jax.grad(lambda q: jnp.sum(jm.network.apply(params, q, prepare_input_gradients=True)
                                       [:, 0].astype(jnp.float32)))(pts[:N_EIK])
        return data + sdf.EIKONAL_WEIGHT * jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        lj, gj = jax.value_and_grad(jloss)(jnp.asarray(p))
    params = tm.trainer.params.detach().requires_grad_(True)
    loss = sdf.sdf_loss(tm.network, params, torch.from_numpy(xs), n_eikonal=N_EIK)
    (grads,) = torch.autograd.grad(loss, params)
    assert abs(float(loss.detach()) - float(lj)) <= 1e-5 * abs(float(lj))
    assert _rel(grads, gj) < 1e-4


def test_main_takes_the_encoding_argument(capsys):
    assert sdf.main(["learn_a_sdf", "PPNG3", "1", "cpu"]) == 0
    assert "SDF with PPNG3" in capsys.readouterr().out
