"""Instant-NGP's NeRF on the port's normal path (models/nerf.py,
ops/volume.py, the config route and the Trainer) against the benchmark's
plain reference (portbench/reference/nerf.py: plain PyTorch, f32, TF32
off, which imports nothing of the port), on the CPU at a small size:
instant-ngp's configs/nerf/base.json with 8 levels and T=2^10, widths as
published, 48 rays of 1 to 16 samples.

At `compute_dtype=torch.float32` the port's CPU route is f32 throughout
(the grid's plain route, the MLPs' f32 matmul chain), so port and
reference compute the same f32 arithmetic in another order: the
tolerances below are float32 round-off. The default bf16 route (the
kernels' twins, what the card computes) is held to bf16's rounding.
"""

import copy
import math
import pathlib
import sys

import pytest
import torch

import tcnn_tpu_torch as tt
from tcnn_tpu_torch.config import create_nerf_network
from tcnn_tpu_torch.models import nerf
from tcnn_tpu_torch.ops import volume
from tcnn_tpu_torch.ops.cuda import train_kernel
from tcnn_tpu_torch.ops.volume import Rays
from tcnn_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import nerf as ref  # noqa: E402
from portbench.reference.field import strict_f32  # noqa: E402

ADAM = {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99, "epsilon": 1e-15,
        "l2_reg": 1e-6}
#: instant-ngp's configs/nerf/base.json, its grid's per_level_scale added
BASE = {
    "loss": {"otype": "Huber"},
    "optimizer": {"otype": "Ema", "decay": 0.95, "nested": {
        "otype": "ExponentialDecay", "decay_start": 20000, "decay_interval": 10000,
        "decay_base": 0.33, "nested": ADAM}},
    "encoding": {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2,
                 "log2_hashmap_size": 19, "base_resolution": 16, "per_level_scale": 1.381913},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "None",
                "n_neurons": 64, "n_hidden_layers": 1},
    "dir_encoding": {"otype": "Composite", "nested": [
        {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
        {"otype": "Identity", "n_bins": 4, "degree": 4}]},
    "rgb_network": {"otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "None",
                    "n_neurons": 64, "n_hidden_layers": 2},
}
SMALL = {**BASE, "encoding": {**BASE["encoding"], "n_levels": 8, "log2_hashmap_size": 10}}
SEED = 2**31 + 23
N_RAYS = 48
#: the table's U(-a, a) bound: large enough that the grid shapes the fields
TABLE_INIT = 0.3
#: float32 round-off of the same arithmetic in another order
F32 = dict(rtol=1e-5, atol=1e-6)


def _rays(seed: int, n_rays: int = N_RAYS):
    """(x [B, 6], Rays): lengths 1-16 (four 1-sample rays), positions in
    the unit cube, unit directions stored as (d + 1) / 2, steps 0.01-0.2
    so that rays range from clear to nearly opaque."""
    gen = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, 17, (n_rays,), generator=gen)
    lengths[[0, 7, 20, n_rays - 1]] = 1
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(lengths, 0)])
    n = int(offsets[-1])
    d = torch.randn(n, 3, generator=gen)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    x = torch.cat([torch.rand(n, 3, generator=gen), (d + 1) * 0.5], 1)
    dt = 0.01 + 0.19 * torch.rand(n, generator=gen)
    return x, Rays(offsets, dt, torch.rand(n_rays, 3, generator=gen), torch.rand(n_rays, 3, generator=gen))


def _batch(x, rays):
    return (x, rays.offsets, rays.dt, rays.background, rays.rgb)


@pytest.fixture(scope="module")
def case():
    m = tt.create_from_config(6, 4, SMALL, device="cpu")
    f = ref.Nerf(SMALL)
    w0 = ref.initial_params(f, SEED, TABLE_INIT, "cpu")
    x, rays = _rays(SEED)
    return m, f, w0, x, rays


def _trainer(m, compute_dtype=torch.float32):
    return tt.Trainer(m.network, copy.deepcopy(m.optimizer), m.loss, device="cpu",
                      compute_dtype=compute_dtype)


def _ref_grad(f, w0, x, rays):
    with strict_f32():
        p = w0.clone().requires_grad_(True)
        loss = ref.loss(f, p, _batch(x, rays))
        (g,) = torch.autograd.grad(loss, p)
    return loss.detach(), g


def test_fields_match_the_reference(case):
    """The density and the colour of every sample, in the output's layout:
    raw rgb in columns 0-2, the raw density in column 3."""
    m, f, w0, x, _ = case
    out = m.network.apply(w0, x, compute_dtype=torch.float32)
    with strict_f32():
        colour, sigma = f.fields(w0, x)
    assert out.shape == (x.shape[0], 16)
    torch.testing.assert_close(torch.sigmoid(out[:, :3]), colour, **F32)
    torch.testing.assert_close(torch.exp(out[:, 3]), sigma, **F32)


def test_ray_colours_and_loss_match_the_reference(case):
    m, f, w0, x, rays = case
    out = m.network.apply(w0, x, compute_dtype=torch.float32)
    with strict_f32():
        colour, sigma = f.fields(w0, x)
        want = ref.composite(colour, sigma, rays.dt, rays.offsets, rays.background)
        loss = ref.loss(f, w0, _batch(x, rays))
    torch.testing.assert_close(volume.composite(torch.sigmoid(out[:, :3]), torch.exp(out[:, 3]), rays),
                               want, **F32)
    torch.testing.assert_close(m.loss(out[:, :3], out[:, 3], rays), loss, **F32)


def test_flat_gradient_matches_the_reference(case):
    """One forward and one backward of the step's route, the gradient
    divided by its loss scale; f32 round-off, relative to the largest
    entry (the gradient spans many magnitudes)."""
    m, f, w0, x, rays = case
    scale = 128.0
    loss, g = nerf.train_grads(m.network, m.loss, w0, x, rays, scale, torch.float32)
    want_loss, want = _ref_grad(f, w0, x, rays)
    torch.testing.assert_close(loss, want_loss, **F32)
    torch.testing.assert_close(g / scale, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))


def test_bf16_route_stays_within_bf16_rounding_of_the_reference(case):
    """The default route (bf16, the kernels' twins): the loss within 1%
    and each leaf's gradient norm within 5% of the reference's: bf16 keeps
    8 bits (2^-9 relative a rounding), and the path rounds the table, the
    encoding, each weight and each layer's output, about a dozen times."""
    m, f, w0, x, rays = case
    loss, g = nerf.train_grads(m.network, m.loss, w0, x, rays, 128.0, torch.bfloat16)
    want_loss, want = _ref_grad(f, w0, x, rays)
    assert abs(float(loss) / float(want_loss) - 1) < 0.01
    for name, b, e in f.leaves():
        got, exp = float(torch.linalg.vector_norm(g[b:e] / 128.0)), float(torch.linalg.vector_norm(want[b:e]))
        assert abs(got - exp) <= 0.05 * exp, name


def test_three_chain_steps_match_the_reference(case):
    """Ema -> ExponentialDecay -> Adam through `Trainer.training_step`:
    the parameters and EMA's average after three steps on three batches.
    Adam's first steps move each weight by about its learning rate, so the
    tolerance is f32 round-off of that (1e-2 x 1e-4)."""
    m, f, w0, _, _ = case
    trainer = _trainer(m)
    trainer.set_params(w0)
    chain = ref.Chain(SMALL["optimizer"], f.n_params, f.n_matrix, "cpu")
    w = w0.clone()
    for i in range(3):
        x, rays = _rays(SEED + i)
        loss = trainer.training_step(x, rays)
        want_loss, g = _ref_grad(f, w, x, rays)
        w = chain.step(w, g)
        torch.testing.assert_close(loss, want_loss, **F32)
    torch.testing.assert_close(trainer.params, w, rtol=0, atol=1e-6)
    torch.testing.assert_close(trainer.state["opt"]["ema"], chain.average, rtol=0, atol=1e-6)


def _loop_loss(rgb_raw, density_raw, rays):
    """The Huber ray loss with each ray composited on its own."""
    rgb, sigma = torch.sigmoid(rgb_raw), torch.exp(density_raw)
    colours = []
    for r in range(rays.n_rays):
        t, c = torch.ones(()), torch.zeros(3)
        for i in range(int(rays.offsets[r]), int(rays.offsets[r + 1])):
            alpha = 1 - torch.exp(-sigma[i] * rays.dt[i])
            c = c + t * alpha * rgb[i]
            t = t * (1 - alpha)
        colours.append(c + t * rays.background[r])
    colours = torch.stack(colours)
    return colours, volume.huber(colours, rays.rgb).sum() / rays.n_rays


def test_ragged_compositing_and_its_gradient_match_a_loop_over_rays():
    """`volume.composite` and the ray loss's written-out gradient against
    each ray composited on its own and differentiated by autograd, over
    densities from clear to opaque and errors inside and outside Huber's
    0.1."""
    gen = torch.Generator().manual_seed(5)
    _, rays = _rays(11)
    n = rays.n_samples
    rgb_raw = (torch.randn(n, 3, generator=gen) * 2).requires_grad_(True)
    density_raw = (torch.randn(n, generator=gen) * 2 + 1).requires_grad_(True)
    want_colours, want_loss = _loop_loss(rgb_raw, density_raw, rays)
    colours = volume.composite(torch.sigmoid(rgb_raw), torch.exp(density_raw), rays)
    torch.testing.assert_close(colours, want_colours, **F32)
    loss = volume.RayLoss()(rgb_raw, density_raw, rays)
    torch.testing.assert_close(loss, want_loss, **F32)
    got = torch.autograd.grad(loss, (rgb_raw, density_raw))
    want = torch.autograd.grad(want_loss, (rgb_raw, density_raw))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("part,n", [("density", 3072), ("rgb", 7168), ("grid", 12_196_240),
                                    ("directions", 0), ("all", 12_206_480)])
def test_parameter_count_at_base_json_sizes(part, n):
    """6,098,120 rows at F=2, levels 5-15 hashed into 2^19; the density
    MLP 32-64-16, the colour MLP 32-64-64-16."""
    net = create_nerf_network(6, 4, BASE)
    parts = {"density": net.density_network, "rgb": net.rgb_network, "grid": net.pos_encoding,
             "directions": net.dir_encoding, "all": net}
    assert parts[part].n_params == n


def test_parameter_layout_is_density_colour_grid(case):
    """[density MLP | colour MLP | grid]: the matrices first, so that
    Adam's L2 and skip rule see 10,240 matrix weights; each slice feeds
    only its own part."""
    m, f, w0, x, _ = case
    net = m.network
    assert net.layer_sizes() == [(64, 16), (16, 64), (64, 32), (64, 64), (16, 64)]
    assert m.optimizer.n_matrix_weights == f.n_matrix == 64 * 16 + 16 * 64 + 64 * 32 + 64 * 64 + 16 * 64
    bounds = [0, 2048, 2048 + 7168, net.n_params]
    base = net.apply(w0, x, compute_dtype=torch.float32)
    for k, (b, e) in enumerate(zip(bounds[:-1], bounds[1:])):
        w = w0.clone()
        w[b:e] *= 1.5
        moved = (net.apply(w, x, compute_dtype=torch.float32) - base).abs().amax(0)
        # the colour MLP's slice moves colours only; the others move the density too
        assert bool(moved[:3].gt(0).all())
        assert bool(moved[3] > 0) == (k != 1)


def test_hyperparams_round_trip_and_checkpoint(case, tmp_path):
    """The model's hyperparams build the same model through the config
    route; `Trainer.save` / `load` restore the parameters and the chain's
    state, and training goes on identically from them."""
    m, _, w0, _, _ = case
    hp = m.network.hyperparams()
    again = tt.create_from_config(6, 4, {**hp, "loss": m.loss.hyperparams(),
                                         "optimizer": m.optimizer.hyperparams()}, device="cpu")
    assert again.network.hyperparams() == hp and again.network.n_params == m.network.n_params
    assert again.optimizer.hyperparams() == m.optimizer.hyperparams()
    a = _trainer(m)
    a.set_params(w0)
    x, rays = _rays(SEED + 7)
    a.training_step(x, rays)
    a.save(str(tmp_path / "nerf.json"))
    b = _trainer(again)
    b.load(str(tmp_path / "nerf.json"))
    torch.testing.assert_close(b.params, a.params, rtol=0, atol=0)
    x, rays = _rays(SEED + 8)
    la, lb = a.training_step(x, rays), b.training_step(x, rays)
    assert float(la) == float(lb)
    torch.testing.assert_close(b.params, a.params, rtol=0, atol=0)
    torch.testing.assert_close(b.state["opt"]["ema"], a.state["opt"]["ema"], rtol=0, atol=0)


def test_fused_kernels_refuse_the_model(case):
    """K6 (`train_kernel.supported`) and K3 (`fused_plan_for`, the gate of
    `Trainer.inference`) take one grid and one MLP: the NeRF trains on the
    composed route and infers through `apply` on EMA's weights; forcing K6
    raises."""
    m, _, w0, x, rays = case
    assert not train_kernel.supported(m.network, m.loss)
    assert train_kernel.fused_plan_for(m.network) is None
    trainer = _trainer(m, torch.bfloat16)
    assert not trainer.use_fused()
    trainer.set_params(w0)
    y = trainer.inference(x)
    assert y.shape == (x.shape[0], 4) and y.dtype == torch.float32
    torch.testing.assert_close(y, m.network.apply(trainer.inference_params, x)[:, :4].float())
    trainer.use_fused_train_kernel = True
    with pytest.raises(ValueError):
        trainer.training_step(x, rays)


def test_one_forward_one_backward_and_spans_once_a_step(case, monkeypatch):
    """Each step runs the fields once and differentiates once, inside
    the spans tcnn.nerf.fields, .composite and .backward under
    tcnn.training_step, and counts its rays and samples once."""
    m, _, w0, x, rays = case
    calls = {"fields": 0, "grad": 0}
    fields, grad = nerf.NerfNetwork.fields, torch.autograd.grad

    def counted(name, f):
        def wrapped(*a, **k):
            calls[name] += 1
            return f(*a, **k)
        return wrapped

    monkeypatch.setattr(nerf.NerfNetwork, "fields", counted("fields", fields))
    monkeypatch.setattr(torch.autograd, "grad", counted("grad", grad))
    trainer = _trainer(m)
    trainer.set_params(w0)
    profiling.reset_recorded()
    steps = 2
    with profiling.recording():
        for _ in range(steps):
            trainer.training_step(x, rays)
    table = profiling.recorded()
    profiling.reset_recorded()
    assert calls == {"fields": steps, "grad": steps}
    for name in ("tcnn.nerf.fields", "tcnn.nerf.composite", "tcnn.nerf.backward"):
        assert table["spans"][name]["count"] == steps
        assert table["spans"][name]["parent"] == "tcnn.training_step"
    assert table["counters"]["nerf.rays"] == steps * N_RAYS
    assert table["counters"]["nerf.samples"] == steps * x.shape[0]


@pytest.mark.parametrize("change,message", [
    ({"loss": {"otype": "L2"}}, "ray loss"),
    ({"n_output_dims": 3}, "outputs 4"),
])
def test_config_route_refuses_what_it_does_not_hold(change, message):
    cfg = {**SMALL, **{k: v for k, v in change.items() if k != "n_output_dims"}}
    with pytest.raises(ValueError, match=message):
        tt.create_from_config(6, change.get("n_output_dims", 4), cfg, device="cpu")


def test_huber_is_instant_ngps():
    """0.5 / 0.1 d^2 inside 0.1, |d| - 0.05 outside, over 5."""
    d = torch.tensor([-0.3, -0.1, 0.0, 0.05, 0.25])
    want = torch.tensor([0.25, 0.05, 0.0, 5 * 0.05 ** 2, 0.2]) / 5
    torch.testing.assert_close(volume.huber(d, torch.zeros(5)), want)
    assert math.isclose(float(volume.huber(torch.tensor(0.1), torch.tensor(0.0))), 0.05 / 5, rel_tol=1e-6)
