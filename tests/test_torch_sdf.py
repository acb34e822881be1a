"""The port's eikonal SDF slice (tcnn_tpu_torch/samples/learn_a_sdf.py) at a
small size on the CPU, against the same computation in tcnn_tpu
(samples/learn_a_sdf.py): a 3-D HashGrid of 4 levels, T = 2^10, into a
16-wide FullyFusedMLP.

Tolerances:
  - the loss and its parameter gradient against the JAX package's own
    route for this model on a TPU backend (simulated; its Pallas kernels in
    interpret mode): both read a bf16 table, run the fused input-gradient
    kernel and its composed second order, and differ only in summation
    order: loss 1e-5 relative (measured 0), gradient 1e-5 norm-relative
    (measured 3.5e-7);
  - the port's fused route against its composed route: the composed first
    order rounds g to bf16 per layer where K9 keeps f32: loss 1e-3
    (measured 6.1e-5), gradient 5e-3 (measured 9.1e-4);
  - Adam steps against the JAX package on the CPU (its XLA route, f32
    table), with Sigmoid hidden units: the loss of each step within 1e-3
    relative (measured up to 1.1e-4) and the params after three steps
    within 1e-2 norm-relative (measured 4.5e-3), from the bf16 table the
    port reads (2^-9 relative per row).
"""

import dataclasses
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
CONFIG = {**sdf.CONFIG,
          "encoding": {**sdf.ENCODING, "n_levels": 4, "log2_hashmap_size": 10},
          "network": {**sdf.CONFIG["network"], "n_neurons": 16}}
B, N_EIK = 512, 128


def _jax_sample():
    spec = importlib.util.spec_from_file_location("jax_learn_a_sdf", ROOT / "samples" / "learn_a_sdf.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pair(seed=0, config=CONFIG):
    jm = tc.create_from_config(3, 1, config)
    tm = tt.create_from_config(3, 1, config, device="cpu")
    p = np.asarray(jm.trainer.params).copy()
    n_net = jm.network.network.n_params
    p[n_net:] = np.random.default_rng(seed).uniform(-0.5, 0.5, p.size - n_net)
    jm.trainer.set_params(jnp.asarray(p))
    tm.trainer.set_params(tt.params_from_jax(p, tm.network.n_params))
    return jm, tm, p


def _jax_loss(jm, params, xs, sdf_true):
    """samples/learn_a_sdf.py:72-94 on the given points."""
    d = sdf_true(xs)[:, None]
    out = jm.network.apply(params, xs)[:, :1].astype(jnp.float32)
    data = jnp.mean((out - d) ** 2)
    g = jax.grad(lambda pts: jnp.sum(
        jm.network.apply(params, pts, prepare_input_gradients=True)[:, 0].astype(jnp.float32)))(
        xs[:N_EIK])
    return data + sdf.EIKONAL_WEIGHT * jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)


def _rel(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_sdf_true_matches_the_jax_sample():
    pts = np.random.default_rng(0).uniform(-0.2, 1.2, (1000, 3)).astype(np.float32)
    want = np.asarray(_jax_sample().sdf_true(jnp.asarray(pts)))
    np.testing.assert_allclose(sdf.sdf_true(torch.from_numpy(pts)).numpy(), want,
                               rtol=1e-6, atol=1e-7)


def test_eikonal_loss_and_gradient_match_jax(monkeypatch):
    jm, tm, p = _pair()
    assert train_kernel.supported_ig(tm.network)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    enc = jm.network.encoding
    enc._kernel_plan_cache = dataclasses.replace(enc._kernel_plan(), batch_tile=256)
    xs = np.random.default_rng(1).uniform(0, 1, (B, 3)).astype(np.float32)
    sdf_true = _jax_sample().sdf_true
    with pltpu.force_tpu_interpret_mode():
        lj, gj = jax.value_and_grad(lambda q: _jax_loss(jm, q, jnp.asarray(xs), sdf_true))(
            jnp.asarray(p))
    params = tm.trainer.params.detach().requires_grad_(True)
    loss = sdf.sdf_loss(tm.network, params, torch.from_numpy(xs), n_eikonal=N_EIK)
    (grads,) = torch.autograd.grad(loss, params)
    loss = loss.detach()
    assert abs(float(loss) - float(lj)) <= 1e-5 * abs(float(lj))
    assert _rel(grads, gj) < 1e-5


def test_fused_and_composed_routes_agree_on_the_step():
    _, tm, _ = _pair(seed=2)
    xs = torch.rand(B, 3, generator=torch.Generator().manual_seed(3))
    lf, gf = sdf.loss_and_grad(tm.trainer, xs, fused_ig=True)
    lc, gc = sdf.loss_and_grad(tm.trainer, xs, fused_ig=False)
    assert abs(float(lf) - float(lc)) <= 1e-3 * abs(float(lc))
    assert _rel(gf, gc) < 5e-3


def test_adam_steps_follow_jax():
    """Three steps of the sample's update (loss_scale 1 into the optimizer,
    the gradient times the trainer's loss_scale) in both packages, with
    Sigmoid hidden units: against the XLA route a ReLU mask flips on a
    hidden unit whose pre-activation rounds differently, and one flipped
    eikonal point moves the loss by percent (measured with ReLU: two of 128
    points, 6% on the first step)."""
    sigmoid = {**CONFIG, "network": {**CONFIG["network"], "activation": "Sigmoid"}}
    jm, tm, p = _pair(seed=4, config=sigmoid)
    sdf_true = _jax_sample().sdf_true
    rng = np.random.default_rng(5)
    state = jm.trainer.state
    for _ in range(3):
        xs = rng.uniform(0, 1, (B, 3)).astype(np.float32)
        lj, gj = jax.value_and_grad(lambda q: _jax_loss(jm, q, jnp.asarray(xs), sdf_true))(
            state["params"])
        opt, params = jm.trainer.optimizer.step(state["opt"], 1.0, state["params"],
                                                gj * jm.trainer.loss_scale)
        state = {**state, "params": params, "opt": opt}
        lt = sdf.train_step(tm.trainer, torch.from_numpy(xs))
        assert abs(float(lt) - float(lj)) <= 1e-3 * abs(float(lj))
    assert _rel(tm.trainer.params, state["params"]) < 1e-2


def test_slice_error_and_device_default():
    _, tm, _ = _pair()
    err = sdf.slice_error(tm.network, tm.trainer.params, n=16)
    assert np.isfinite(err) and err > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sdf.main(["learn_a_sdf", "1"])
