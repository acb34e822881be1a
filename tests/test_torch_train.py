"""The port's training slice on the CPU: the fused train step (kernel K6's
plain twin, tcnn_tpu_torch/ops/cuda/train_kernel.py), the composed autograd
route, the Trainer with Adam, snapshots with the optimizer state, and the
package boundary, held against tcnn_tpu.

Model: the 6-level, T=2^10, 64x2 grid + FullyFusedMLP of
tests/test_train_kernel.py:20-45, batch 600 (not a tile multiple). Inputs are
made with numpy and handed to both packages; the JAX Pallas kernels run in
interpret mode.

Tolerances:
  - K6's twin vs tcnn_tpu's `fused_train_grads`: loss rtol 1e-3 (as
    test_train_kernel.py:70); gradient norm-relative error below 2e-3.
    Both keep g in f32 through the MLP backward, read a bf16 table and round
    each scatter contribution to bf16; they differ in summation order, in
    the last f32 bit of a corner weight (which can flip a bf16 rounding) and
    in the loss normalisation (per tile and rescaled, or once). Measured
    4e-5 to 2.4e-4 on these cases (F = 8: 4.3e-5).
  - K6's twin vs the port's composed route: norm-relative 2^-6. The composed
    route rounds the loss gradient and every layer's g to bf16, as tcnn_tpu's
    composed backward does; measured 2.5e-4 to 1.7e-3.
  - One Adam step after either: the moments norm-relative 2e-3 (linear and
    quadratic in g); the step (new - old params) norm-relative 1e-2, at most
    0.1% of the params apart by more than lr/10 and none by more than 2 lr.
    A first Adam step is about lr * sign(g) wherever |g| is well above
    epsilon, so where |g| is tiny its last percents, which bf16 flips in the
    scatter move, set the step (measured: 2.4e-3 norm-relative, 0.01% beyond
    lr/10, 0.2 lr at most; after two earlier steps 4.3e-4, none, 0.007 lr).
  - The 60-step trajectory of tests/test_trajectory.py: every loss within
    6% of the golden run's and the final param sum within 5%. The golden run
    used tcnn_tpu's f32-table XLA route; the port reads the table in bf16 and
    rounds the scatter to bf16, and the difference grows along the run
    (measured: at most 2.9% per step, 2.2% on the param sum).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu.ops.pallas.train_kernel import fused_train_grads as jax_fused_train_grads
from tcnn_tpu_torch.ops.cuda import mlp_kernel, train_kernel
from tcnn_tpu_torch.utils import profiling

B = 600


def _cfg(loss="RelativeL2", out_act="None", **enc):
    return {
        "loss": {"otype": loss},
        "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
        "encoding": {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
                     "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 1.6,
                     **enc},
        "network": {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2,
                    "output_activation": out_act},
    }


def _pair(cfg, seed=0):
    """Both packages from one config, with tcnn_tpu's params (table redrawn
    from U(-1, 1)) carried into the port; the JAX fused kernel at a 256-row
    plan tile, as test_train_kernel.py runs it."""
    jm = tc.create_from_config(2, 3, cfg)
    enc = jm.network.encoding
    enc._kernel_plan_cache = dataclasses.replace(enc._kernel_plan(), batch_tile=256)
    tm = tt.create_from_config(2, 3, cfg, seed=seed + 11, device="cpu")
    p = np.asarray(jm.trainer.params).copy()
    n_net = jm.network.network.n_params
    p[n_net:] = np.random.default_rng(seed).uniform(-1, 1, p.size - n_net)
    jm.trainer.set_params(jnp.asarray(p))
    tm.trainer.set_params(tt.params_from_jax(p, tm.network.n_params))
    return jm, tm


def _batch(seed, out_w=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(B, 2)).astype(np.float32),
            rng.uniform(size=(B, out_w)).astype(np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy (JAX arrays are read-only)


# ---------------------------------------------------------------------------
# K6's twin against tcnn_tpu's fused train kernel
# ---------------------------------------------------------------------------

_CASES = [
    ("RelativeL2", "None", "plain"),
    ("L2", "Sigmoid", "pdf"),
    ("L1", "None", "noise"),
    ("SMAPE", "Exponential", "max_level"),
    ("RelativeL2", "None", "ext_dl"),
    ("RelativeL2", "None", "f8"),  # 8 features per level: a 128-wide MLP input
]


@pytest.mark.parametrize("loss,out_act,extra", _CASES)
def test_fused_twin_matches_jax_fused_train_grads(loss, out_act, extra):
    jm, tm = _pair(_cfg(loss, out_act, **({"n_features_per_level": 8} if extra == "f8" else {})))
    x, t = _batch(1)
    rng = np.random.default_rng(2)
    kw = {}
    if extra == "pdf":
        kw["pdf"] = rng.uniform(0.5, 1.5, (B, 3)).astype(np.float32)
    elif extra == "noise":
        kw["noise"] = (0.1 * rng.normal(size=(B, 16))).astype(np.float32)
    elif extra == "ext_dl":
        t = rng.normal(size=(B, 16)).astype(np.float32)
        kw["ext_dl"] = True
    elif extra == "max_level":
        jm.network.encoding.max_level = 0.5
        tm.network.encoding.update_hyperparams({"max_level": 0.5})
    p = np.asarray(jm.trainer.params)
    with pltpu.force_tpu_interpret_mode():
        jl, jg = jax_fused_train_grads(
            jm.network, jm.trainer.loss_fn, jnp.asarray(p), jnp.asarray(x), jnp.asarray(t),
            jm.trainer.loss_scale,
            **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    tl, tg = train_kernel.fused_train_grads(
        tm.network, tm.trainer.loss_fn, tm.trainer.params, _t(x), _t(t), tm.trainer.loss_scale,
        **{k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    assert tl.dim() == 0 and tg.dtype == torch.float32 and tuple(tg.shape) == (p.size,)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    assert _rel(tg, np.asarray(jg)) < 2e-3, _rel(tg, np.asarray(jg))
    if extra == "max_level":
        n_net = tm.network.network.n_params
        enc = tm.network.encoding
        first_off = n_net + int(enc._offsets[enc.active_levels()]) * enc.n_features_per_level
        assert not tg[first_off:].any()


@pytest.mark.parametrize("loss,out_act,use_pdf", [("RelativeL2", "None", False),
                                                  ("L2", "Sigmoid", True),
                                                  ("RelativeL2Luminance", "None", False)])
def test_fused_twin_matches_composed_autograd(loss, out_act, use_pdf):
    _, tm = _pair(_cfg(loss, out_act), seed=3)
    x, t = _batch(4)
    pdf = _t(np.random.default_rng(5).uniform(0.5, 1.5, (B, 3)).astype(np.float32)) if use_pdf else None
    tr = tm.trainer
    assert tr.use_fused()
    fl, fg = tr.loss_and_grad_fn(tr.params, _t(x), _t(t), pdf)
    tr.use_fused_train_kernel = False
    cl, cg = tr.loss_and_grad_fn(tr.params, _t(x), _t(t), pdf)
    np.testing.assert_allclose(float(fl), float(cl), rtol=1e-5)
    assert _rel(fg, cg) < 2.0**-6, _rel(fg, cg)


# ---------------------------------------------------------------------------
# Whole steps against tcnn_tpu's train_step_fn
# ---------------------------------------------------------------------------


def _jax_opt_numpy(state):
    return {k: np.asarray(v) for k, v in state.items()}


def _check_after_step(tm, jstate, before, lr=1e-2):
    """The port's params and Adam state against tcnn_tpu's after the same
    step from the same `before` params."""
    tr = tm.trainer
    jo = _jax_opt_numpy(jstate["opt"])
    for k in ("first_moments", "second_moments"):
        assert _rel(tr.state["opt"][k], jo[k]) < 2e-3, (k, _rel(tr.state["opt"][k], jo[k]))
    np.testing.assert_array_equal(tr.state["opt"]["step"].numpy(), jo["step"])
    steps_differ = (tr.state["opt"]["param_steps"].numpy() != jo["param_steps"]).mean()
    assert steps_differ < 1e-3, steps_differ  # zero gradients only where both have them
    got, want = tr.params.numpy(), np.asarray(jstate["params"])
    diff = np.abs(got - want)
    assert _rel(got - before, want - before) < 1e-2, _rel(got - before, want - before)
    assert diff.max() <= 2 * lr * 1.0001, diff.max()
    assert (diff > lr / 10).mean() < 1e-3, (diff > lr / 10).mean()
    assert np.abs(got - before).max() > 0.5 * lr  # the step moved the params


def test_training_step_matches_jax_train_step():
    jm, tm = _pair(_cfg())
    x, t = _batch(6)
    before = np.asarray(jm.trainer.params).copy()
    jtr = jm.trainer
    jtr.use_fused_train_kernel = True
    with pltpu.force_tpu_interpret_mode():
        jstate, jl = jtr.train_step_fn(jtr.state, jnp.asarray(x), jnp.asarray(t))
    tl = tm.trainer.training_step(_t(x), _t(t))
    assert tl.dim() == 0 and tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    _check_after_step(tm, jstate, before)


def test_jax_snapshot_resumes_in_port(tmp_path):
    """A tcnn_tpu snapshot with its optimizer block (two XLA-route steps)
    loads into the port, and the next step matches tcnn_tpu's next step."""
    jm, _ = _pair(_cfg())
    jtr = jm.trainer
    for s in range(2):
        x, t = _batch(10 + s)
        jtr.training_step(jnp.asarray(x), jnp.asarray(t))
    path = tmp_path / "jax.json"
    jtr.save(str(path))
    tm = tt.create_from_config(2, 3, _cfg(), seed=99, device="cpu")
    tm.trainer.load(str(path))
    jo = _jax_opt_numpy(jtr.state["opt"])
    assert np.array_equal(tm.trainer.params.numpy(), np.asarray(jtr.params))
    for k, v in tm.trainer.state["opt"].items():
        assert v.dtype == (torch.int64 if k in ("param_steps", "step") else torch.float32)
        np.testing.assert_array_equal(v.numpy(), jo[k])
    x, t = _batch(12)
    before = np.asarray(jtr.params).copy()
    jtr.use_fused_train_kernel = True
    with pltpu.force_tpu_interpret_mode():
        jstate, jl = jtr.train_step_fn(jtr.state, jnp.asarray(x), jnp.asarray(t))
    tl = tm.trainer.training_step(_t(x), _t(t))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    _check_after_step(tm, jstate, before)


def test_trajectory_follows_golden():
    import pathlib

    from test_trajectory import CONFIG, N_STEPS, TRAJ_PATH

    ref = np.load(TRAJ_PATH)
    jm = tc.create_from_config(2, 3, CONFIG)
    tm = tt.create_from_config(2, 3, CONFIG, device="cpu")
    assert tm.trainer.use_fused()
    tm.trainer.set_params(tt.params_from_jax(np.asarray(jm.trainer.params), tm.network.n_params))
    key = jax.random.PRNGKey(1337)  # the golden run's inputs
    losses = []
    for _ in range(N_STEPS):
        key, k = jax.random.split(key)
        x = jax.random.uniform(k, (2048, 2))
        t = jnp.stack([jnp.sin(6 * x[:, 0]) * 0.5 + 0.5, jnp.cos(4 * x[:, 1]) * 0.5 + 0.5,
                       x[:, 0] * x[:, 1]], -1)
        losses.append(float(tm.trainer.training_step(_t(np.asarray(x)), _t(np.asarray(t)))))
    np.testing.assert_allclose(losses, ref["losses"], rtol=0.06)
    np.testing.assert_allclose(float(tm.trainer.params.sum()), float(ref["param_sum"]), rtol=0.05)
    assert pathlib.Path(TRAJ_PATH).exists()


# ---------------------------------------------------------------------------
# The Trainer's own contract
# ---------------------------------------------------------------------------


def test_snapshot_round_trip_with_optimizer_state(tmp_path):
    _, tm = _pair(_cfg(), seed=7)
    tr = tm.trainer
    for s in range(2):
        tr.training_step(*map(_t, _batch(20 + s)))
    snap = json.loads(json.dumps(tr.serialize()))
    assert snap["optimizer"]["state"]["treedef"] == (
        "PyTreeDef({'first_moments': *, 'param_steps': *, 'second_moments': *, 'step': *})")
    assert [leaf["dtype"] for leaf in snap["optimizer"]["state"]["leaves"]] == [
        "<f4", "<u4", "<f4", "<u4"]
    tr.save(str(tmp_path / "port.json"))
    fresh = tt.create_from_config(2, 3, _cfg(), seed=5, device="cpu")
    fresh.trainer.load(str(tmp_path / "port.json"))
    for k, v in tr.state["opt"].items():
        assert torch.equal(fresh.trainer.state["opt"][k], v)
    x, t = map(_t, _batch(22))
    assert torch.equal(fresh.trainer.training_step(x, t), tr.training_step(x, t))
    assert torch.equal(fresh.trainer.params, tr.params)
    # a snapshot without the optimizer block keeps the current state
    fresh.trainer.deserialize(tr.serialize(serialize_optimizer=False))
    assert torch.equal(fresh.trainer.state["opt"]["step"], tr.state["opt"]["step"])


def test_opt_state_from_jax():
    jm, tm = _pair(_cfg())
    jm.trainer.training_step(*map(jnp.asarray, _batch(30)))
    st = tt.opt_state_from_jax(_jax_opt_numpy(jm.trainer.state["opt"]), tm.trainer.state["opt"])
    assert st["param_steps"].dtype == torch.int64 and st["step"].dim() == 0
    assert int(st["step"]) == 1 and int(st["param_steps"].max()) == 1
    with pytest.raises(ValueError, match="keys"):
        tt.opt_state_from_jax({"step": np.zeros((), np.uint32)}, tm.trainer.state["opt"])


def test_inference_cache_follows_the_optimizer_step():
    _, tm = _pair(_cfg(), seed=8)
    tr = tm.trainer
    x = torch.rand(64, 2)
    before = tr.inference(x)
    prep = tr._prepared()
    tr.training_step(*map(_t, _batch(31)))  # Adam updates the params in place
    assert tr._prepared() is not prep
    after = tr.inference(x)
    assert not torch.equal(before, after)
    assert torch.equal(after, tm.network.apply(tr.params, x)[:, :3].float())


def test_external_dl_doutput():
    """An external dL/doutput gives loss 0 and a gradient without
    loss_scale, on both routes (trainer.h:127-131)."""
    _, tm = _pair(_cfg(), seed=9)
    tr = tm.trainer
    x = _t(_batch(32)[0])
    dl = _t(np.random.default_rng(33).normal(size=(B, 16)).astype(np.float32))
    fused = tr.external_grad_fn(tr.params, x, dl)
    tr.use_fused_train_kernel = False
    composed = tr.external_grad_fn(tr.params, x, dl)
    assert _rel(fused, composed) < 2.0**-6
    _, scaled = train_kernel.fused_train_grads(tm.network, tr.loss_fn, tr.params, x, dl, 1.0,
                                               ext_dl=True)
    assert torch.equal(scaled, fused)  # loss_scale does not enter
    tr.use_fused_train_kernel = None
    before = tr.params.clone()
    loss = tr.training_step(x, dL_doutput=dl)
    assert loss.dim() == 0 and float(loss) == 0.0
    assert not torch.equal(before, tr.params)


def test_route_gate():
    _, tm = _pair(_cfg())
    assert train_kernel.supported(tm.network, tm.trainer.loss_fn)
    assert tm.trainer.use_fused()
    cut = tt.create_from_config(2, 3, {**_cfg(), "network": {"otype": "CutlassMLP",
                                                             "n_neurons": 32,
                                                             "n_hidden_layers": 1}},
                               device="cpu")
    assert not cut.trainer.use_fused()
    loss = cut.trainer.training_step(*map(_t, _batch(34)))  # composed route
    assert bool(torch.isfinite(loss))
    cut.trainer.use_fused_train_kernel = True
    with pytest.raises(ValueError, match="does not take"):
        cut.trainer.training_step(*map(_t, _batch(34)))
    # stochastic interpolation, once refused, now takes K6 (its twin here)
    stoch = tt.create_from_config(2, 3, _cfg(stochastic_interpolation=True), device="cpu")
    assert stoch.trainer.use_fused() and stoch.network.encoding.plan.stochastic
    assert bool(torch.isfinite(stoch.trainer.training_step(*map(_t, _batch(35)))))
    lum = tt.create_from_config(2, 1, _cfg("RelativeL2Luminance"), device="cpu")
    assert not train_kernel.supported(lum.network, lum.trainer.loss_fn)
    dims = tm.network.network.dims
    assert mlp_kernel.bwd_tile(dims) == 128
    big = mlp_kernel.MlpDims(32, 128, 5, 16, dims.activation, dims.output_activation)
    # 128 x 5 takes K6's 16-row tile: its padded weights take 153,856 bytes
    assert mlp_kernel.bwd_smem_bytes(big, 16) <= mlp_kernel.SMEM_OPTIN
    assert mlp_kernel.bwd_smem_bytes(big, 32) > mlp_kernel.SMEM_OPTIN
    assert mlp_kernel.bwd_tile(big) == 16


def test_forward_loss_and_hyperparams():
    _, tm = _pair(_cfg(), seed=12)
    tr = tm.trainer
    x, t = map(_t, _batch(36))
    ctx = tr.forward(x, t)
    assert tuple(ctx["output"].shape) == (B, 16) and tuple(ctx["loss_values"].shape) == (B, 16)
    fused_loss, _ = tr.loss_and_grad_fn(tr.params, x, t)
    np.testing.assert_allclose(tr.loss(ctx), float(fused_loss), rtol=1e-5)
    tr.update_hyperparams({"optimizer": {"learning_rate": 0.5}, "loss": {"otype": "L1"}})
    assert tr.optimizer.learning_rate == 0.5 and tr.loss_fn.otype == "L1"


def test_perturbation_noise():
    """Logistic output noise from the trainer's generator: the same seed
    gives the same steps; the noise moves the loss."""
    losses = []
    for sigma in (0.5, 0.5, 0.0):
        m = tt.create_from_config(2, 3, _cfg(), device="cpu")
        m.trainer.perturbation_sigma = sigma
        losses.append(float(m.trainer.training_step(*map(_t, _batch(37)))))
    assert losses[0] == losses[1] != losses[2]
    m = tt.create_from_config(2, 3, _cfg(), device="cpu")
    m.trainer.perturbation_sigma = 1.0
    noise = m.trainer._noise((20000,))
    # logistic(0, s): mean 0, standard deviation s * pi / sqrt(3)
    assert abs(float(noise.mean())) < 0.05
    assert abs(float(noise.std()) - np.pi / np.sqrt(3)) < 0.05


def test_no_kernel_counter_moves_on_cpu():
    before = profiling.counts("launches.")
    _, tm = _pair(_cfg(), seed=13)
    tr = tm.trainer
    x, t = map(_t, _batch(38))
    tr.training_step(x, t)
    tr.training_step(x, dL_doutput=torch.zeros(B, 16))
    tr.use_fused_train_kernel = False
    tr.training_step(x, t)
    tr.inference(x)
    assert profiling.counts("launches.") == before


# ---------------------------------------------------------------------------
# data/config_oneblob.json: OneBlob (64 bins) into a FullyFusedMLP
# ---------------------------------------------------------------------------


def test_config_oneblob_loads_and_steps_with_jax(monkeypatch):
    """The reference's second image config loads unchanged (a 128-wide
    input into 128 x 5); at reduced width (64 x 2) one step on the composed
    route (OneBlob in torch, K2 and K5's twins, Adam) matches tcnn_tpu's
    Trainer step on its TPU route (`jax.default_backend` patched, its MLP
    kernels in interpret mode) within this file's step tolerances."""
    cfg = tt.load_config("data/config_oneblob.json")
    full = tt.create_from_config(2, 3, cfg, device="cpu")
    assert full.network.encoding.hyperparams() == {"otype": "OneBlob", "n_bins": 64}
    assert full.network.network.dims == mlp_kernel.MlpDims(
        128, 128, 5, 16, tt.Activation.ReLU, tt.Activation.NONE)
    assert full.network.n_params == tc.create_from_config(2, 3, cfg).network.n_params
    cfg["network"].update(n_neurons=64, n_hidden_layers=2)
    jm = tc.create_from_config(2, 3, cfg)
    tm = tt.create_from_config(2, 3, cfg, device="cpu")
    tm.trainer.set_params(tt.params_from_jax(np.asarray(jm.trainer.params), tm.network.n_params))
    assert not tm.trainer.use_fused()
    x, t = _batch(40)
    before = np.asarray(jm.trainer.params).copy()
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        jstate, jl = jm.trainer.train_step_fn(jm.trainer.state, jnp.asarray(x), jnp.asarray(t))
    tl = tm.trainer.training_step(_t(x), _t(t))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    _check_after_step(tm, jstate, before)


def test_mlp_tiles_at_config_oneblob_shape():
    """Input 128 into 128 x 5: K5 takes 16-row tiles (213,248 bytes of the
    232,448 opt-in; 32 rows would take 248,064) and K2's block fits."""
    dims = mlp_kernel.MlpDims(128, 128, 5, 16, tt.Activation.ReLU, tt.Activation.NONE)
    assert mlp_kernel.mlp_bwd_tile(dims) == 16
    assert mlp_kernel.mlp_bwd_smem_bytes(dims, 16) == 213_248 <= mlp_kernel.SMEM_OPTIN
    assert mlp_kernel.mlp_bwd_smem_bytes(dims, 32) > mlp_kernel.SMEM_OPTIN
    warps = mlp_kernel.frag_tile_warps(dims)
    assert warps == 8
    assert mlp_kernel.frag_tile_smem_bytes(dims, warps) <= mlp_kernel.SMEM_OPTIN
