"""Stochastic interpolation in the port, on the CPU: the draws
(`stochastic_uniforms`, ops/threefry.py), the chosen corners
(`grid_kernel.stochastic_rows`), the table gradient of K4's stochastic
option (its twin) and the fused train step K6 with the stochastic and Rng
options (its twin), against tcnn_tpu.

Tolerances:
  - draws and chosen rows: bit-equal / exact;
  - the table gradient against tcnn_tpu's Pallas `_bwd_stoch_kernel`
    (interpret mode), for a cotangent of bf16 values: both add the same
    bf16 rows into the same rows in f32, in another order: rtol 1e-5 plus
    one bf16 ulp of the largest value, as tests/test_torch_grid_bwd.py.
    These cases draw x in [0, 1]: below 0, tcnn_tpu's Pallas kernels take
    a dense level whose size is not a power of two modulo its size in f32
    on a negative int32 index, and pick other rows than its XLA route and
    the reference's uint32 index (ROADMAP Queue C); the XLA cases draw x
    from [-0.2, 1.2];
  - against tcnn_tpu's XLA `_apply_stochastic` for an f32 cotangent: the
    port rounds each row to bf16 as the TPU kernels do and XLA does not, so
    each contribution moves by at most 2^-9 of itself: norm-relative 2^-8;
  - K6's twin: tests/test_torch_train.py's bounds (gradient norm-relative
    2e-3, loss rtol 1e-3); whole Trainer steps: its Adam-step checks, the
    step's norm-relative bound at 3e-2 (test_training_steps_match_jax_trainer
    says why).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu.ops.pallas import grid_kernel as jax_grid_kernel
from tcnn_tpu.ops.pallas.train_kernel import fused_train_grads as jax_fused_train_grads
from tcnn_tpu_torch.ops.cuda import grid_kernel, train_kernel
from tcnn_tpu_torch.utils import profiling
from tcnn_tpu_torch.ops.encodings.grid import stochastic_uniforms
from test_torch_grid_bwd import _jax_bwd
from test_torch_train import _batch, _cfg, _pair, _rel, _t


def _enc_cfg(**kw):
    cfg = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
           "log2_hashmap_size": 8, "base_resolution": 4, "per_level_scale": 1.7,
           "stochastic_interpolation": True}
    cfg.update(kw)
    return cfg


def _inputs(d, cfg, seed, batch=300, lo=-0.2, hi=1.2):
    je, te = tc.create_encoding(d, cfg), tt.create_encoding(d, cfg)
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (batch, d)).astype(np.float32)
    gy = rng.normal(size=(batch, te.n_output_dims)).astype(np.float32)
    return je, te, x, gy


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _jax_stoch_bwd(je, x, gy):
    """`_grid_pallas_bwd` of the stochastic plan, which runs the TPU kernel
    `_bwd_stoch_kernel` on the draws over the true batch, padded."""
    plan = jax_grid_kernel.plan_for(je)
    assert plan.stochastic
    b, nt = x.shape[0], plan.batch_tile
    padded = -(-b // nt) * nt
    u = jax_grid_kernel.stochastic_u_padded(b, padded, plan.n_levels)
    xp = jnp.pad(jnp.asarray(x), ((0, padded - b), (0, 0)))
    gyp = jnp.pad(jnp.asarray(gy).astype(jnp.bfloat16), ((0, padded - b), (0, 0)))
    with pltpu.force_tpu_interpret_mode():
        g, _, _ = jax_grid_kernel._grid_pallas_bwd(plan, je.n_params, (xp, u), gyp)
    return np.asarray(g)


def _xla_grad(je, x, gy, max_level=None):
    """jax.vjp of tcnn_tpu's XLA stochastic encoding (`_apply_stochastic`)."""
    p = jnp.zeros(je.n_params, jnp.float32)
    f = lambda q: je.apply_unpadded(q, jnp.asarray(x), impl="xla", needs_input_grad=False,  # noqa: E731
                                    compute_dtype=jnp.float32, max_level=max_level)
    return np.asarray(jax.vjp(f, p)[1](jnp.asarray(gy))[0])


def _port_grad(te, x, gy, max_level=None):
    params = torch.zeros(te.n_params, requires_grad=True)
    te.apply_unpadded(params, torch.from_numpy(x), max_level=max_level).backward(
        torch.from_numpy(gy).to(torch.bfloat16))
    return params.grad.numpy()


# ---------------------------------------------------------------------------
# The draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,levels", [(37, 5), (600, 16)])
def test_stochastic_uniforms_bit_equal_to_jax(batch, levels):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(1337), (batch, levels)))
    got = stochastic_uniforms(batch, levels, "cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_stochastic_uniforms_sampled_rows_of_a_full_batch():
    """4096 rows of the (2^18, 16) draw config_hash's step makes: u[b, l]
    depends on b * L + l alone."""
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(1337), (1 << 18, 16)))
    rows = np.sort(np.random.default_rng(0).choice(1 << 18, 4096, replace=False))
    got = stochastic_uniforms(1 << 18, 16, "cpu").numpy()[rows]
    np.testing.assert_array_equal(got.view(np.int32), want[rows].view(np.int32))
    # a smaller batch draws the same rows
    np.testing.assert_array_equal(stochastic_uniforms(600, 16, "cpu").numpy(), want[:600])


# ---------------------------------------------------------------------------
# The chosen corners
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("interp", ["Linear", "Smoothstep"])
@pytest.mark.parametrize("hash_type", ["CoherentPrime", "Rng"])
def test_stochastic_rows_match_jax(interp, hash_type):
    d = 3 if hash_type == "Rng" else 2
    je, te, x, _ = _inputs(d, _enc_cfg(interpolation=interp, hash=hash_type), seed=d)
    assert te.plan.stochastic and any(te.plan.use_hash)
    want = np.asarray(je._stochastic_corner_rows(jnp.asarray(x)))
    got = grid_kernel.stochastic_rows(te.plan, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def _tie_x(u, scale):
    """An f32 x whose position at `scale` has the fraction u exactly:
    fl(fl(x * scale) + 0.5) = u."""
    u, scale = np.float32(u), np.float32(scale)
    x = np.float32((u - np.float32(0.5)) / scale)
    for _ in range(200):
        pos = np.float32(np.float32(x * scale) + np.float32(0.5))
        if pos == u:
            return x
        x = np.nextafter(x, np.float32(np.inf) if pos < u else np.float32(-np.inf))
    raise AssertionError("no tie found")


def test_stochastic_ties_choose_the_lower_corner():
    """Bit d is set where u < w_d, strictly: where w_d equals u, the corner
    keeps cell d (grid.h:288-296), in the twin and in tcnn_tpu."""
    je, te, x, _ = _inputs(2, _enc_cfg(), seed=9, batch=64)
    plan = te.plan
    u = stochastic_uniforms(64, plan.n_levels, "cpu").numpy()
    ties = []
    for b in range(0, 64, 4):
        l = b % plan.n_levels
        x[b, 0] = _tie_x(u[b, l], plan.scales[l])
        ties.append((b, l))
    xt = torch.from_numpy(x)
    cells, w = grid_kernel.positions(xt, torch.from_numpy(plan.scales), plan.interpolation)
    for b, l in ties:
        assert float(w[b, l, 0]) == float(u[b, l])
    got = grid_kernel.stochastic_rows(plan, xt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(je._stochastic_corner_rows(jnp.asarray(x))))
    for b, l in ties:
        bit1 = bool(u[b, l] < float(w[b, l, 1]))
        want = grid_kernel._rows(plan, cells + torch.tensor([0, int(bit1)]))[b, l]
        assert int(got[b, l]) == int(want)


# ---------------------------------------------------------------------------
# The table gradient (K4's stochastic option)
# ---------------------------------------------------------------------------

_GRAD_CASES = [("CoherentPrime", None, 2), ("Rng", None, 2), ("CoherentPrime", 0.5, 3),
               ("Rng", 0.5, 3)]


@pytest.mark.parametrize("hash_type,max_level,d", _GRAD_CASES)
def test_stochastic_gradient_matches_pallas(hash_type, max_level, d):
    je, te, x, gy = _inputs(d, _enc_cfg(hash=hash_type), seed=10 + d, lo=0.0, hi=1.0)
    gy = _bf16(gy)
    if max_level is not None:  # the mask the JAX package applies after its kernel
        keep = np.arange(te.n_levels) < max_level * te.n_levels + 1e-3
        want = _jax_stoch_bwd(je, x, gy * np.repeat(keep, te.n_features_per_level)[None])
    else:
        want = _jax_stoch_bwd(je, x, gy)
    got = _port_grad(te, x, gy, max_level)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2.0**-8 * np.abs(gy).max())
    if max_level is not None:
        off = int(te._offsets[te.active_levels(max_level)]) * te.n_features_per_level
        assert not got[off:].any() and np.abs(got[:off]).max() > 0


@pytest.mark.parametrize("hash_type,max_level,d", _GRAD_CASES)
def test_stochastic_gradient_matches_xla(hash_type, max_level, d):
    je, te, x, gy = _inputs(d, _enc_cfg(hash=hash_type, interpolation="Smoothstep"), seed=20 + d)
    want = _xla_grad(je, x, gy, max_level)
    got = grid_kernel._grid_backward_plain(
        te.plan, torch.from_numpy(x), torch.from_numpy(gy), te.active_levels(max_level))
    assert _rel(got.reshape(-1), want) < 2.0**-8
    # the whole mass of each (sample, level) lands on one row
    mass = got.reshape(-1, te.n_features_per_level).sum(0).numpy()
    n_active = te.active_levels(max_level)
    g = torch.from_numpy(gy).to(torch.bfloat16).float().reshape(len(x), te.n_levels, -1)
    np.testing.assert_allclose(mass, g[:, :n_active].sum((0, 1)).numpy(), rtol=1e-4, atol=1e-3)


def test_nearest_turns_stochastic_off_as_the_pallas_plan_does():
    """Under Nearest the JAX package's Pallas plan drops stochastic
    interpolation (grid_kernel.py:140-142), so its scatter goes to the
    forward's cell; its XLA route (`_stochastic_corner_rows`, grid.py:
    452-474) ignores Nearest and moves a sample's row to a neighbouring cell
    where u < fract. The port follows the Pallas plan."""
    cfg = _enc_cfg(interpolation="Nearest")
    je, te, x, gy = _inputs(2, cfg, seed=30, lo=0.0, hi=1.0)
    gy = _bf16(gy)
    assert not te.plan.stochastic and not jax_grid_kernel.plan_for(je).stochastic
    got = _port_grad(te, x, gy)
    np.testing.assert_allclose(got, _jax_bwd(je, x, gy), rtol=1e-5,
                               atol=2.0**-8 * np.abs(gy).max())
    det = tt.create_encoding(2, {**cfg, "stochastic_interpolation": False})
    assert np.array_equal(got, _port_grad(det, x, gy))
    xla = _xla_grad(je, x, gy)
    assert _rel(got, xla) > 0.5  # the XLA route scattered elsewhere


def test_stochastic_backward_launches_nothing_on_cpu_and_refuses_input_gradients():
    te = tt.create_encoding(2, _enc_cfg())
    before = profiling.counts("launches.")
    params = torch.zeros(te.n_params, requires_grad=True)
    te.apply(params, torch.rand(20, 2)).float().sum().backward()
    assert profiling.counts("launches.") == before and params.grad.abs().sum() > 0
    # input gradients take the plain route: dL/dx through the exact
    # interpolation (tests/test_torch_grid_route.py holds it against tcnn_tpu)
    x8 = torch.rand(8, 2, requires_grad=True)
    table = torch.rand(te.n_params) * 2 - 1
    (gx,) = torch.autograd.grad(te.apply(table, x8, needs_input_grad=True).float().sum(), x8)
    xe = x8.detach().requires_grad_(True)
    (want,) = torch.autograd.grad(te.interpolate_f32(table, xe).sum(), xe)
    assert gx.abs().sum() > 0
    torch.testing.assert_close(gx, want)
    assert profiling.counts("launches.") == before
    table = torch.zeros(te.plan.total_rows, te.plan.f, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="stochastic"):
        grid_kernel.grid_backward_ig(te.plan, table, torch.rand(8, 2),
                                     torch.zeros(8, 8, dtype=torch.bfloat16))
    other = copy.copy(te.plan)
    other.draw_seed = 1338
    x = torch.rand(100, 2)
    assert not torch.equal(grid_kernel.stochastic_rows(other, x),
                           grid_kernel.stochastic_rows(te.plan, x))


# ---------------------------------------------------------------------------
# K6 with the stochastic and Rng options, and whole steps
# ---------------------------------------------------------------------------

_OPTIONS = {"stochastic": {"stochastic_interpolation": True}, "rng": {"hash": "Rng"},
            "both": {"stochastic_interpolation": True, "hash": "Rng"}}


@pytest.mark.parametrize("option", list(_OPTIONS))
def test_fused_twin_matches_jax_fused_train_grads(option):
    jm, tm = _pair(_cfg(**_OPTIONS[option]))
    assert train_kernel.supported(tm.network, tm.trainer.loss_fn) and tm.trainer.use_fused()
    x, t = _batch(40)
    p = np.asarray(jm.trainer.params)
    with pltpu.force_tpu_interpret_mode():
        jl, jg = jax_fused_train_grads(jm.network, jm.trainer.loss_fn, jnp.asarray(p),
                                       jnp.asarray(x), jnp.asarray(t), jm.trainer.loss_scale)
    tl, tg = train_kernel.fused_train_grads(tm.network, tm.trainer.loss_fn, tm.trainer.params,
                                            _t(x), _t(t), tm.trainer.loss_scale)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    assert _rel(tg, np.asarray(jg)) < 2e-3, _rel(tg, np.asarray(jg))


@pytest.mark.parametrize("option", list(_OPTIONS))
def test_training_steps_match_jax_trainer(option):
    """Three steps of each config from the same flat params and batches,
    each step from tcnn_tpu's params before it. Adam's step on a table
    entry that a step touches for the first time is lr * sign(g) wherever
    |g| is well above epsilon, so one entry whose tiny gradient has the
    other sign moves the step by 2 lr (norm-relative 1e-2 to 2.1e-2 with
    the Rng hash, which touches other rows on every batch): the steps are
    held to tests/test_torch_train.py's checks with the step's
    norm-relative bound at 3e-2."""
    jm, tm = _pair(_cfg(**_OPTIONS[option]), seed=41)
    jtr = jm.trainer
    jtr.use_fused_train_kernel = True
    tr = tm.trainer
    lr = 1e-2
    for step in range(3):
        x, t = _batch(50 + step)
        before = np.asarray(jtr.params).copy()
        tr.set_params(_t(before))
        with pltpu.force_tpu_interpret_mode():
            jstate, jl = jtr.train_step_fn(jtr.state, jnp.asarray(x), jnp.asarray(t))
        jtr.state = jstate
        tl = tr.training_step(_t(x), _t(t))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
        jo = {k: np.asarray(v) for k, v in jstate["opt"].items()}
        for k in ("first_moments", "second_moments"):
            assert _rel(tr.state["opt"][k], jo[k]) < 2e-3, k
        np.testing.assert_array_equal(tr.state["opt"]["step"].numpy(), jo["step"])
        assert (tr.state["opt"]["param_steps"].numpy() != jo["param_steps"]).mean() < 1e-3
        got, want = tr.params.numpy(), np.asarray(jstate["params"])
        diff = np.abs(got - want)
        assert _rel(got - before, want - before) < 3e-2, _rel(got - before, want - before)
        assert diff.max() <= 2 * lr * 1.0001 and (diff > lr / 10).mean() < 1e-3
        assert np.abs(got - before).max() > 0.5 * lr
