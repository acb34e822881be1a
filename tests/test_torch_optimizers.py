"""The port's optimizers (tcnn_tpu_torch/optimizers/) against tcnn_tpu's on
the CPU: every otype the JAX registry builds, instant-ngp's NeRF chain
(EMA -> ExponentialDecay -> Adam) and two Composites, stepped from the same
numpy weights and gradients; their snapshots both ways; a Trainer under the
chain; and the inference cache under EMA.

The model is layer sizes [(16, 8), (16, 16), (4, 16)] and 300 non-matrix
weights, 30% of whose gradients are exact zeros (Adam's skip rule). 12
steps cross every schedule: ExponentialDecay starting at 2 every 3 steps,
Batched and Lookahead every 3, Average's ring of 4 and Shampoo's refresh at
step 1 and round robin at steps 3, 6, 9 and 12 (3 groups, 10 // 3 = 3).

Bounds: rtol 1e-6 and atol 1e-7 for the elementwise optimizers (as
tests/test_torch_adam.py: both packages evaluate the same f32 expressions
elementwise); the integer leaves exactly. Shampoo's products sum in another
order than XLA's, and its 30 coupled-Newton iterations and Frobenius
normalisation carry those roundings on: every leaf within 1e-4 of its norm
(norm-relative; measured at most 1.4e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu.utils import serialization as jax_serialization
from tcnn_tpu_torch.utils.serialization import (
    tree_from_json,
    tree_leaves,
    tree_to_json,
    treedef_string,
)

SIZES = [(16, 8), (16, 16), (4, 16)]
N_MATRIX = sum(r * c for r, c in SIZES)
N = N_MATRIX + 300
N_STEPS = 12
LOSS_SCALE = 128.0
ELEMENTWISE = dict(rtol=1e-6, atol=1e-7)
SHAMPOO_REL = 1e-4

ADAM = {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99, "epsilon": 1e-15,
        "l2_reg": 1e-6}
#: instant-ngp's configs/nerf/base.json optimizer, its decay moved to step 2
#: every 3 so that 12 steps cross it
CHAIN = {"otype": "Ema", "decay": 0.95, "nested": {
    "otype": "ExponentialDecay", "decay_start": 2, "decay_interval": 3, "decay_base": 0.33,
    "nested": ADAM}}

CONFIGS = {
    "SGD": {"otype": "SGD", "learning_rate": 1e-2, "l2_reg": 1e-4},
    "Novograd": {"otype": "Novograd", "learning_rate": 1e-2, "relative_decay": 0.01,
                 "absolute_decay": 1e-4},
    "Shampoo": {"otype": "Shampoo", "learning_rate": 1e-2},
    "Shampoo raw": {"otype": "Shampoo", "learning_rate": 1e-2, "cg_on_momentum": False,
                    "frobenius_normalization": False, "relative_decay": 0.01,
                    "absolute_decay": 1e-4},
    "EMA": {"otype": "EMA", "decay": 0.9, "nested": ADAM},
    "EMA of Lookahead": {"otype": "EMA", "decay": 0.9, "nested": {
        "otype": "Lookahead", "alpha": 0.5, "n_steps": 3, "nested": ADAM}},
    "Average": {"otype": "Average", "n_samples": 4, "nested": ADAM},
    "Lookahead": {"otype": "Lookahead", "alpha": 0.5, "n_steps": 3, "nested": ADAM},
    "Batched": {"otype": "Batched", "batch_size_multiplier": 3, "nested": ADAM},
    "ExponentialDecay": {"otype": "ExponentialDecay", "decay_start": 2, "decay_interval": 3,
                         "decay_base": 0.5, "nested": {"otype": "SGD", "learning_rate": 1e-2}},
    "chain": CHAIN,
    "Composite": {"otype": "Composite", "nested": [
        {**ADAM, "n_params_to_optimize": N_MATRIX}, {"otype": "SGD", "learning_rate": 1e-1}]},
    "Composite cut": {"otype": "Composite", "nested": [
        {"otype": "Novograd", "learning_rate": 1e-2, "n_params_to_optimize": 200},
        {"otype": "EMA", "decay": 0.9, "nested": ADAM}]},
}


def _grads(rng):
    g = (rng.normal(size=N) * LOSS_SCALE).astype(np.float32)
    g[N_MATRIX:][rng.uniform(size=N - N_MATRIX) < 0.3] = 0.0
    return g


def _pair(cfg):
    jo, to = tc.create_optimizer(cfg), tt.create_optimizer(cfg)
    jo.allocate(N, SIZES)
    to.allocate(N, SIZES)
    return jo, to


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _assert_close(got, want, shampoo):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want)
    elif shampoo:
        assert _rel(got, want) <= SHAMPOO_REL, _rel(got, want)
    else:
        np.testing.assert_allclose(got, want, **ELEMENTWISE)


def _assert_states(ts, js, shampoo):
    assert treedef_string(ts) == str(jax.tree_util.tree_structure(js))
    for got, want in zip(tree_leaves(ts), jax.tree_util.tree_leaves(js)):
        _assert_close(got.numpy(), want, shampoo)


def _run(name, n_steps=N_STEPS, seed=0):
    """n_steps of both optimizers; tcnn_tpu's Shampoo step jitted, as its
    Trainer runs it (eagerly, its 30 Newton iterations take seconds)."""
    jo, to = _pair(CONFIGS[name])
    jstep = jax.jit(jo.step) if "Shampoo" in name else jo.step
    rng = np.random.default_rng(seed)
    w0 = rng.uniform(-1, 1, N).astype(np.float32)
    js, ts = jo.init_state(), to.init_state(device="cpu")
    jw, tw = jnp.asarray(w0), torch.from_numpy(w0.copy())
    for _ in range(n_steps):
        g = _grads(rng)
        js, jw = jstep(js, LOSS_SCALE, jw, jnp.asarray(g))
        to.step(ts, LOSS_SCALE, tw, torch.from_numpy(g))
    return jo, to, js, ts, jw, tw


@pytest.mark.parametrize("name", list(CONFIGS))
def test_optimizer_matches_tcnn_tpu(name):
    shampoo = "Shampoo" in name
    jo, to, js, ts, jw, tw = _run(name)
    _assert_close(tw.numpy(), jw, shampoo)
    _assert_states(ts, js, shampoo)
    jcw, tcw = jo.custom_weights(js, jw), to.custom_weights(ts, tw)
    assert (jcw is None) == (tcw is None)
    if jcw is not None:
        _assert_close(tcw.numpy(), jcw, shampoo)
    assert to.learning_rate == jo.learning_rate
    assert to.hyperparams() == jo.hyperparams()


def test_instant_ngp_chain_decays_and_filters():
    """The chain's factor is 0.33^k after k decays (at nested steps 2, 5, 8
    and 11 of 12), and its custom weights are the debiased EMA."""
    _, to, _, ts, _, tw = _run("chain")
    assert float(ts["nested"]["lr_factor"]) == pytest.approx(0.33**4, rel=1e-6)
    assert int(ts["step"]) == N_STEPS and int(ts["nested"]["nested"]["step"]) == N_STEPS
    cw = to.custom_weights(ts, tw)
    want = ts["ema"] / (1 - 0.95**N_STEPS)
    torch.testing.assert_close(cw, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("step", [1, 2, 3, 4, 100, 200, 201])
def test_shampoo_refresh_schedule(step):
    """Every group at step 1, then one group every (step < 100 ? 10 : 200)
    // 3 steps in turn, as tcnn_tpu's lax.cond predicate selects."""
    jo, to = _pair(CONFIGS["Shampoo"])
    groups = to.groups()
    assert [(c, s) for c, s, _ in groups] == [(1, (16, 8)), (1, (16, 16)), (1, (4, 16))]
    single = max((10 if step < 100 else 200) // 3, 1)
    want = [j for j in range(3)
            if step == 1 or (step % single == 0 and (step // single) % 3 == j)]
    assert to.refresh_groups(step) == want


def test_batched_skips_the_nested_step_off_its_window():
    jo, to, js, ts, jw, tw = _run("Batched", n_steps=4)
    assert int(ts["nested"]["step"]) == 1 and int(ts["step"]) == 4
    _assert_states(ts, js, False)


@pytest.mark.parametrize("name", ["chain", "Composite cut", "Shampoo", "Average"])
def test_snapshots_cross_both_ways(name):
    shampoo = "Shampoo" in name
    jo, to, js, ts, jw, tw = _run(name, n_steps=5)
    port_snap = tree_to_json(ts)
    assert port_snap["treedef"] == str(jax.tree_util.tree_structure(js))
    back = jax_serialization.tree_from_json(port_snap, jo.init_state())
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(js)):
        _assert_close(got, want, shampoo)
    jax_snap = jax_serialization.tree_to_json(js)
    assert jax_snap["treedef"] == treedef_string(ts)
    fresh = tt.create_optimizer(CONFIGS[name])
    fresh.allocate(N, SIZES)
    loaded = tree_from_json(jax_snap, fresh.init_state(device="cpu"))
    fresh.load_state(loaded)
    _assert_states(loaded, js, shampoo)
    # the host-side step counts follow the loaded state: one more step agrees
    rng = np.random.default_rng(99)
    g = _grads(rng)
    js, jw = (jax.jit(jo.step) if shampoo else jo.step)(js, LOSS_SCALE, jw, jnp.asarray(g))
    w = tw.clone()
    fresh.step(loaded, LOSS_SCALE, w, torch.from_numpy(g))
    _assert_close(w.numpy(), jw, shampoo)
    _assert_states(loaded, js, shampoo)


def test_update_hyperparams_and_learning_rate_reach_nested():
    to = tt.create_optimizer(CONFIGS["chain"])
    jo = tc.create_optimizer(CONFIGS["chain"])
    for o in (to, jo):
        o.update_hyperparams({"decay": 0.5, "nested": {"decay_base": 0.1,
                                                       "nested": {"learning_rate": 3e-3}}})
        o.set_learning_rate(2e-3)
    assert to.hyperparams() == jo.hyperparams()
    assert to.learning_rate == 2e-3 and to.nested.nested.learning_rate == 2e-3
    comp = tt.create_optimizer(CONFIGS["Composite"])
    comp.update_hyperparams({"nested": [{"learning_rate": 5e-3}, {"l2_reg": 0.5}]})
    assert comp.learning_rate == 5e-3 and comp.nested[1].l2_reg == 0.5


def test_registry_builds_every_jax_otype():
    from tcnn_tpu import registry as jax_registry

    for name in jax_registry._OPTIMIZER_FACTORIES:
        cfg = {"otype": name}
        if name in ("ema", "average", "batched", "lookahead", "exponentialdecay"):
            cfg["nested"] = {"otype": "SGD"}
        if name == "composite":
            cfg["nested"] = [{"otype": "Adam"}]
        assert type(tt.create_optimizer(cfg)).__name__ == type(tc.create_optimizer(cfg)).__name__
    opt = tt.create_optimizer({"otype": "sgd", "n_params_to_optimize": 7})
    assert opt.n_params_to_optimize == 7
    with pytest.raises(ValueError, match="not found"):
        tt.create_optimizer({"otype": "Adagrad"})


def _grid_cfg(optimizer):
    return {"loss": {"otype": "L2"}, "optimizer": optimizer,
            "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                         "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 1.6},
            "network": {"otype": "FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 1}}


def test_trainer_trains_under_the_chain_as_tcnn_tpu():
    """5 composed-route steps of both packages from the same params. The
    port's composed route reads the table in bf16 and rounds each table
    contribution to bf16 where tcnn_tpu's XLA route keeps f32
    (tests/test_torch_train.py); the bound holds that: losses within 1e-3
    relative (measured at most 5.1e-5), params and EMA weights within 1e-2
    norm-relative (measured 1.5e-3 and 8.9e-4)."""
    cfg = _grid_cfg(CHAIN)
    jm = tc.create_from_config(2, 1, cfg)
    tm = tt.create_from_config(2, 1, cfg, device="cpu")
    tm.trainer.use_fused_train_kernel = False
    p = np.asarray(jm.trainer.params).copy()
    tm.trainer.set_params(tt.params_from_jax(p, tm.network.n_params))
    rng = np.random.default_rng(5)
    for _ in range(5):
        x = rng.uniform(size=(256, 2)).astype(np.float32)
        t = np.sin(4 * x[:, :1]).astype(np.float32)
        jl = float(jm.trainer.training_step(jnp.asarray(x), jnp.asarray(t)))
        tl = float(tm.trainer.training_step(torch.from_numpy(x), torch.from_numpy(t)))
        assert tl == pytest.approx(jl, rel=1e-3)
    assert _rel(tm.trainer.params.numpy(), jm.trainer.params) < 1e-2
    assert _rel(tm.trainer.inference_params.numpy(), jm.trainer.inference_params) < 1e-2
    assert float(tm.trainer.state["opt"]["nested"]["lr_factor"]) == pytest.approx(0.33)


def test_ema_inference_builds_operands_once_between_steps(monkeypatch):
    """K3's prepared operands are keyed on the params and every optimizer
    leaf, not on the fresh tensor EMA's custom weights give each call."""
    tm = tt.create_from_config(2, 1, _grid_cfg(CHAIN), device="cpu")
    calls = []
    real = tt.trainer.prepare_forward
    monkeypatch.setattr(tt.trainer, "prepare_forward",
                        lambda model, p: calls.append(1) or real(model, p))
    tr = tm.trainer
    x = torch.rand(64, 2)
    tr.training_step(x, torch.rand(64, 1))
    outs = [tr.inference(x) for _ in range(10)]
    assert len(calls) == 1 and all(torch.equal(o, outs[0]) for o in outs)
    want = tm.network.apply(tr.inference_params, x)[:, :1].float()
    torch.testing.assert_close(outs[0], want, rtol=0, atol=2.0**-6)
    tr.training_step(x, torch.rand(64, 1))
    after = tr.inference(x)
    assert len(calls) == 2 and not torch.equal(after, outs[0])


def test_shampoo_pins_full_f32_matmuls(monkeypatch):
    """A Shampoo step runs its matmuls at full f32 whatever the process set
    (TF32 would turn roots into NaN on the card), and restores the setting."""
    from tcnn_tpu_torch.optimizers import shampoo

    seen = []
    real = shampoo.inverse_fourth_root
    monkeypatch.setattr(shampoo, "inverse_fourth_root",
                        lambda a: seen.append(torch.get_float32_matmul_precision()) or real(a))
    _, to = _pair(CONFIGS["Shampoo"])
    state, w = to.init_state(device="cpu"), torch.zeros(N)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        to.step(state, LOSS_SCALE, w, torch.from_numpy(_grads(np.random.default_rng(1))))
        after = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(before)
    assert seen == ["highest"] * 6 and after == "high"
