"""The port's Adam (tcnn_tpu_torch/optimizers/adam.py) against the
reference's 40-step golden trajectory (golden.npz, as
tests/test_golden.py:201-228) and against tcnn_tpu's AdamOptimizer.step on
the same numpy inputs, on the CPU.

Tolerances: the golden trajectory at test_golden.py's own atol 1e-5 and
rtol 1e-4; one step against tcnn_tpu at rtol 1e-6 and atol 1e-7, since
both evaluate the same f32 expressions elementwise; the exact-zero skip
rule exactly.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu_torch as tt
from tcnn_tpu.optimizers.adam import AdamOptimizer as JaxAdam
from tcnn_tpu_torch.optimizers.adam import AdamOptimizer

G = np.load(pathlib.Path(__file__).parent / "golden" / "golden.npz")

_GOLDEN_KW = dict(
    learning_rate=1e-2, beta1=0.9, beta2=0.99, epsilon=1e-8, l2_reg=1e-5,
    relative_decay=0.01, absolute_decay=0.001, clipping_magnitude=1.5,
    non_matrix_learning_rate_factor=0.5,
)


def test_adam_golden_trajectory():
    opt = AdamOptimizer(**_GOLDEN_KW)
    opt.allocate(160, [(12, 8)])  # 96 matrix weights, 64 non-matrix
    assert opt.n_matrix_weights == 96
    state = opt.init_state(device="cpu")
    w = torch.from_numpy(G["adam_w0"][:, 0].copy())
    for s in range(40):
        opt.step(state, 128.0, w, torch.from_numpy(G["adam_grads"][s]) * 128.0)
    for got, key in ((w, "adam_w_final"), (state["first_moments"], "adam_m1_final"),
                     (state["second_moments"], "adam_m2_final")):
        np.testing.assert_allclose(got.numpy(), G[key][:, 0], atol=1e-5, rtol=1e-4)
    assert int(state["step"]) == 40


def _compare_steps(kw, n_steps, seed, zero_share=0.0):
    """n_steps of both optimizers on the same numpy weights and gradients."""
    rng = np.random.default_rng(seed)
    n, sizes = 200, [(8, 10)]
    jo, to = JaxAdam(**kw), AdamOptimizer(**kw)
    jo.allocate(n, sizes)
    to.allocate(n, sizes)
    js, ts = jo.init_state(), to.init_state(device="cpu")
    w0 = rng.uniform(-1, 1, n).astype(np.float32)
    jw, tw = jnp.asarray(w0), torch.from_numpy(w0.copy())
    for _ in range(n_steps):
        g = (rng.normal(size=n) * 128.0).astype(np.float32)
        g[rng.uniform(size=n) < zero_share] = 0.0
        js, jw = jo.step(js, 128.0, jw, jnp.asarray(g))
        to.step(ts, 128.0, tw, torch.from_numpy(g))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    for k in ("first_moments", "second_moments"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-6, atol=1e-7)
    for k in ("param_steps", "step"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


@pytest.mark.parametrize(
    "kw",
    [
        dict(learning_rate=1e-2, adabound=True),
        dict(learning_rate=5e-2, clipping_magnitude=0.3),
        dict(learning_rate=1e-2, relative_decay=0.1, absolute_decay=0.01,
             non_matrix_learning_rate_factor=3.0, l2_reg=1e-3),
        dict(learning_rate=1e-2, optimize_matrix_params=False),
    ],
    ids=["adabound", "clipping", "decay", "frozen_matrix"],
)
def test_adam_matches_tcnn_tpu(kw):
    _compare_steps(kw, n_steps=6, seed=len(kw), zero_share=0.3)


def test_exact_zero_gradients_leave_non_matrix_params_alone():
    opt = AdamOptimizer(learning_rate=1e-2, l2_reg=1e-3)
    opt.allocate(20, [(2, 5)])  # 10 matrix, 10 non-matrix
    state = opt.init_state(device="cpu")
    w = torch.linspace(-1, 1, 20)
    g = torch.ones(20)
    g[12:16] = 0.0  # untouched table rows
    g[2:4] = 0.0  # zero gradient on matrix weights: not skipped (l2_reg)
    before = w.clone()
    for _ in range(3):
        opt.step(state, 1.0, w, g)
    skip = torch.zeros(20, dtype=torch.bool)
    skip[12:16] = True
    assert torch.equal(w[skip], before[skip])
    assert not torch.equal(w[2:4], before[2:4])
    assert not state["first_moments"][skip].any() and not state["second_moments"][skip].any()
    assert state["param_steps"].tolist() == [0 if s else 3 for s in skip.tolist()]
    assert int(state["step"]) == 3


def test_registry_and_hyperparams():
    opt = tt.create_optimizer({"otype": "adam", "learning_rate": 0.5, "beta2": 0.9})
    assert opt.learning_rate == 0.5 and opt.beta2 == 0.9 and opt.custom_weights({}) is None
    opt.update_hyperparams({"learning_rate": 0.25})
    assert opt.hyperparams()["learning_rate"] == 0.25
    # the other otypes build as in tcnn_tpu (tests/test_torch_optimizers.py
    # holds their steps); an EMA defaults to an Adam nested inside
    for name in ("SGD", "Shampoo", "EMA"):
        assert type(tt.create_optimizer({"otype": name})).__name__.lower().startswith(name.lower())
    assert isinstance(tt.create_optimizer({"otype": "EMA"}).nested, AdamOptimizer)
