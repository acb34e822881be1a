"""The port's Adam (tcnn_tpu_torch/optimizers/adam.py) against the
reference's 40-step golden trajectory (golden.npz, as
tests/test_golden.py:201-228) and against tcnn_tpu's AdamOptimizer.step on
the same numpy inputs, on the CPU.

Tolerances: the golden trajectory at test_golden.py's own atol 1e-5 and
rtol 1e-4; one step against tcnn_tpu at rtol 1e-6 and atol 1e-7, since
both evaluate the same f32 expressions elementwise; the exact-zero skip
rule exactly.
"""

import ctypes
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu_torch as tt
from tcnn_tpu.optimizers.adam import AdamOptimizer as JaxAdam
from tcnn_tpu_torch.ops.cuda import adam_kernel
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


def _stepped_state(kw, n=200, n_matrix=80, steps=3, seed=3):
    """An Adam of `kw` on n params (the first n_matrix a matrix) after a
    few CPU steps on gradients with exact zeros: (opt, state, w, next g)."""
    gen = torch.Generator().manual_seed(seed)
    opt = AdamOptimizer(**kw)
    opt.allocate(n, [(n_matrix // 8, 8)])
    state = opt.init_state(device="cpu")
    w = torch.rand(n, generator=gen) * 2 - 1

    def grad():
        g = torch.randn(n, generator=gen) * 128.0
        g[torch.rand(n, generator=gen) < 0.3] = 0.0
        return g

    for _ in range(steps):
        opt.step(state, 128.0, w, grad())
    return opt, state, w, grad()


def _f32(v):
    """A scalar argument as K14 receives it: rounded to f32 by ctypes."""
    return torch.tensor(ctypes.c_float(v).value, dtype=torch.float32)


def _k14_emulated(opt, state, loss_scale, w, g, lr_scale):
    """csrc/adam.cu's element rule in f32 torch on the CPU, from the
    wrapper's scalar arguments (adam_kernel.scalar_args): each operation
    rounded alone, in the kernel's order. Returns the new (w, state)."""
    (n_matrix, ls, l2, b1, c1, b2, c2, eps, lr_m, lr_nm, factor, rel, absd, clip,
     flags) = adam_kernel.scalar_args(opt, loss_scale, lr_scale)
    m1, m2, ps = state["first_moments"], state["second_moments"], state["param_steps"]
    is_matrix = torch.arange(w.numel()) < n_matrix
    g0 = g / _f32(ls)
    active = torch.where(is_matrix, bool(flags & adam_kernel.OPTIMIZE_MATRIX),
                         bool(flags & adam_kernel.OPTIMIZE_NON_MATRIX) & (g0 != 0))
    g1 = torch.where(is_matrix, g0 + w * _f32(l2), g0)
    nm1 = m1 * _f32(b1) + g1 * _f32(c1)
    nm2 = m2 * _f32(b2) + (g1 * _f32(c2)) * g1
    t = (ps + 1).float()
    if isinstance(lr_scale, torch.Tensor):
        lr_matrix = lr_scale * _f32(lr_m)
        lr_non_matrix = lr_matrix * _f32(factor)
    else:
        lr_matrix, lr_non_matrix = _f32(lr_m), _f32(lr_nm)
    lr = torch.where(is_matrix, lr_matrix, lr_non_matrix)
    lr = lr * torch.sqrt(1 - float(_f32(b2)) ** t)
    lr = lr / (1 - float(_f32(b1)) ** t)
    if flags & adam_kernel.ADABOUND:
        c = (state["step"] + 1).float() * _f32(c2)
        lower, upper = 0.1 - (c + 1).reciprocal() * 0.1, c.reciprocal() * 0.1 + 0.1
    else:
        lower, upper = 0.0, torch.finfo(torch.float32).max
    eff = torch.clamp(lr / (torch.sqrt(nm2) + _f32(eps)), lower, upper)
    new_w = (1 - lr * _f32(rel)) * w - torch.copysign(lr * _f32(absd), w) - eff * nm1
    if flags & adam_kernel.CLIP:
        new_w = torch.clamp(new_w, -float(_f32(clip)), float(_f32(clip)))
    out = {"first_moments": torch.where(active, nm1, m1),
           "second_moments": torch.where(active, nm2, m2),
           "param_steps": ps + active, "step": state["step"] + 1}
    return torch.where(active, new_w, w), out


_K14_CASES = {
    "config_hash": dict(learning_rate=1e-2, beta2=0.99, epsilon=1e-15, l2_reg=1e-6),
    "adabound": dict(learning_rate=1e-2, adabound=True),
    "decay": dict(learning_rate=1e-2, relative_decay=0.1, absolute_decay=0.01, l2_reg=1e-3),
    "clipping": dict(learning_rate=5e-2, clipping_magnitude=0.3),
    "non_matrix_factor": dict(learning_rate=1e-2, non_matrix_learning_rate_factor=0.3),
    "frozen_matrix": dict(learning_rate=1e-2, optimize_matrix_params=False),
    "frozen_non_matrix": dict(learning_rate=1e-2, optimize_non_matrix_params=False),
    "golden": _GOLDEN_KW,
}


@pytest.mark.parametrize("tensor_lr", [False, True], ids=["float_lr_scale", "tensor_lr_scale"])
@pytest.mark.parametrize("kw", list(_K14_CASES.values()), ids=list(_K14_CASES))
def test_kernel_arguments_reproduce_the_twin_bit_for_bit(kw, tensor_lr):
    """K14's scalar arguments, rounded to f32 as ctypes passes them, and its
    element rule give the twin's step bit for bit on every leaf."""
    opt, state, w, g = _stepped_state(kw)
    lr_scale = torch.tensor(0.37) if tensor_lr else 0.37
    want_w, want = w.clone(), {k: v.clone() for k, v in state.items()}
    opt.step(want, 128.0, want_w, g, lr_scale)
    got_w, got = _k14_emulated(opt, state, 128.0, w, g, lr_scale)
    assert torch.equal(got_w.view(torch.int32), want_w.view(torch.int32))
    for k in want:
        a, b = got[k], want[k]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k


def test_a_step_bumps_the_version_of_every_tensor_it_writes():
    """Trainer._prepared keys K3's operands on (id, _version) of the params
    and every optimizer leaf: a step bumps the weights' and each leaf's
    version (on the card K14's wrapper bumps them after its ctypes write),
    and leaves the gradient's alone."""
    opt, state, w, g = _stepped_state(_K14_CASES["config_hash"], steps=1)
    before = {k: t._version for k, t in state.items()}
    w_version, g_version = w._version, g._version
    opt.step(state, 128.0, w, g)
    assert w._version > w_version and g._version == g_version
    assert all(state[k]._version > v for k, v in before.items())


def _bad_args(case):
    """(state, weights, grads, lr_scale) with one argument K14 refuses."""
    n = 40
    opt = AdamOptimizer()
    opt.allocate(n, [(4, 5)])
    state, w, g, lr = opt.init_state(device="cpu"), torch.zeros(n), torch.zeros(n), 1.0
    if case == "grads_f64":
        g = g.double()
    elif case == "weights_f16":
        w = w.half()
    elif case == "param_steps_int32":
        state["param_steps"] = state["param_steps"].int()
    elif case == "weights_strided":
        w = torch.zeros(2 * n)[::2]
    elif case == "moments_strided":
        state["first_moments"] = torch.zeros(n, 2)[:, 0]
    elif case == "grads_too_long":
        g = torch.zeros(n + 1)
    elif case == "moments_too_short":
        state["second_moments"] = torch.zeros(n - 1)
    elif case == "step_not_0d":
        state["step"] = torch.zeros(1, dtype=torch.int64)
    elif case == "lr_scale_f64":
        lr = torch.tensor(0.5, dtype=torch.float64)
    elif case == "lr_scale_1d":
        lr = torch.ones(1)
    return n, state, w, g, lr


@pytest.mark.parametrize("case", ["grads_f64", "weights_f16", "param_steps_int32",
                                  "weights_strided", "moments_strided", "grads_too_long",
                                  "moments_too_short", "step_not_0d", "lr_scale_f64",
                                  "lr_scale_1d"])
def test_the_kernel_route_refuses_what_k14_does_not_take(case):
    n, state, w, g, lr = _bad_args(case)
    adam_kernel.check_adam_args(*_bad_args("none"))  # the same, unchanged, passes
    with pytest.raises(ValueError):
        adam_kernel.check_adam_args(n, state, w, g, lr)
