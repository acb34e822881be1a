"""The port's module API (tcnn_tpu_torch/modules.py) and its image sample
(tcnn_tpu_torch/samples/mlp_learning_an_image_modules.py) against
tcnn_tpu.modules on the CPU, from the same flat params.

Tolerances:
  - a grid + FullyFusedMLP module against tcnn_tpu's on its TPU route
    (`jax.default_backend` patched to "tpu", the Pallas kernels in
    interpret mode, as tests/test_torch_sdf.py runs it): both read a bf16
    table; `__call__` runs K1 -> K2's twins against the Pallas forward, and
    `fwd` / `bwd` the fused input-gradient route (K3, K9's twins) against
    `fused_apply_ig`. Outputs within one bf16 ulp of the largest (2^-7;
    measured equal), gradients 1e-5 norm-relative (measured 1e-7 to
    3.5e-7), as test_torch_sdf.py holds the same kernels;
  - `Network` and a grid `Encoding` against tcnn_tpu's on the CPU (its XLA
    route, f32 table): outputs within 2^-5 of the largest, as
    tests/test_torch_slice.py holds the port against the XLA route; the
    grid's input gradient 5e-3 norm-relative, test_torch_grid_ig.py's
    bound against XLA.
"""

import dataclasses
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu_torch.utils import profiling
from tcnn_tpu_torch.samples import mlp_learning_an_image_modules as sample
from tcnn_tpu_torch.utils.image import psnr, synthetic_image

ENC = {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2,
       "log2_hashmap_size": 12, "base_resolution": 4, "per_level_scale": 1.5}
NET = {"otype": "FullyFusedMLP", "n_neurons": 32, "n_hidden_layers": 2}
B = 300  # not a multiple of 128


def _rel(got, want):
    got, want = np.asarray(got, np.float64).ravel(), np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _copy_params(jmod, tmod, seed=0):
    """tcnn_tpu's init with the table redrawn from U(-1, 1), into both."""
    p = np.asarray(jmod.params).copy()
    n_net = getattr(jmod.model, "network", None)
    n_net = 0 if n_net is None else n_net.n_params
    p[n_net:] = np.random.default_rng(seed).uniform(-1, 1, p.size - n_net)
    jmod.params = jnp.asarray(p)
    with torch.no_grad():
        tmod.params.copy_(tt.params_from_jax(p, tmod.n_params))
    return p


@pytest.fixture
def grid_pair(monkeypatch):
    """A grid + FullyFusedMLP module in both packages, tcnn_tpu's on its TPU
    route in interpret mode (256-row plan tile)."""
    jmod = tc.NetworkWithInputEncoding(2, 3, ENC, NET)
    tmod = tt.NetworkWithInputEncoding(2, 3, ENC, NET, device="cpu")
    _copy_params(jmod, tmod)
    enc = jmod.model.encoding
    enc._kernel_plan_cache = dataclasses.replace(enc._kernel_plan(), batch_tile=256)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    return jmod, tmod


def _x(seed, n=B, d=2):
    return np.random.default_rng(seed).uniform(0, 1, (n, d)).astype(np.float32)


def test_call_and_fwd_bwd_in_every_gradient_mode(grid_pair):
    jmod, tmod = grid_pair
    assert isinstance(tmod, torch.nn.Module) and list(tmod.parameters()) == [tmod.params]
    assert tmod.n_params == jmod.n_params and tmod.hyperparams() == jmod.hyperparams()
    x, x1 = _x(1), _x(9, n=1)
    dl = np.random.default_rng(2).normal(size=(B, 3)).astype(np.float32)
    acc = np.random.default_rng(3).normal(size=tmod.n_params).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_y = np.asarray(jmod(jnp.asarray(x)))
        want_y1 = np.asarray(jmod(jnp.asarray(x1)))
        jy, vjp = jmod.fwd(jnp.asarray(x))
        want = {mode: jmod.bwd(vjp, jnp.asarray(dl), gradient_mode=mode,
                               param_grads=jnp.asarray(acc))
                for mode in (tc.GradientMode.Overwrite, tc.GradientMode.Accumulate,
                             tc.GradientMode.Ignore)}
    for xx, wy in ((x, want_y), (x1, want_y1)):
        y = tmod(torch.from_numpy(xx))
        assert y.dtype == torch.float32 and tuple(y.shape) == (xx.shape[0], 3)
        assert np.abs(y.detach().numpy() - wy).max() <= 2.0**-7 * np.abs(wy).max()
    y, ctx = tmod.fwd(torch.from_numpy(x))
    assert not y.requires_grad
    assert np.abs(y.numpy() - np.asarray(jy)).max() <= 2.0**-7 * np.abs(jy).max()
    got = {}
    for jmode, tmode in zip(want, (tt.GradientMode.Overwrite, tt.GradientMode.Accumulate,
                                   tt.GradientMode.Ignore)):
        got[tmode] = tmod.bwd(ctx, torch.from_numpy(dl), gradient_mode=tmode,
                              param_grads=torch.from_numpy(acc))
        (wp, wx), (gp, gx) = want[jmode], got[tmode]
        assert tuple(gx.shape) == (B, 2) and _rel(gx, wx) < 1e-5
        if tmode == tt.GradientMode.Ignore:
            assert wp is None and gp is None
        else:
            assert gp.dtype == torch.float32 and _rel(gp, wp) < 1e-5
    ow, ac, ig = (got[getattr(tt.GradientMode, m)] for m in ("Overwrite", "Accumulate", "Ignore"))
    assert ig[0] is None and torch.equal(ig[1], ow[1])
    assert torch.equal(ac[0], ow[0] + torch.from_numpy(acc)) and torch.equal(ac[1], ow[1])
    assert torch.equal(tmod.bwd(ctx, torch.from_numpy(dl))[0], ow[0])  # Overwrite by default
    with pytest.raises(ValueError, match="param_grads"):
        tmod.bwd(ctx, torch.from_numpy(dl), gradient_mode=tt.GradientMode.Accumulate)


def test_call_under_autograd_trains_with_an_external_optimizer():
    """`module(x)` differentiates in params (K5 -> K4's twins) and, for an
    x that requires a gradient, in x to second order."""
    m = tt.NetworkWithInputEncoding(2, 3, ENC, NET, device="cpu")
    opt = torch.optim.Adam(m.parameters(), lr=1e-2)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(10):
        x = torch.rand(B, 2, generator=gen)
        loss = sample.relative_l2(m(x), torch.stack([x[:, 0], x[:, 1], x.prod(1)], 1))
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.5 * losses[0]
    x = torch.rand(B, 2, generator=gen, requires_grad=True)
    (g,) = torch.autograd.grad(m(x)[:, 0].sum(), x, create_graph=True)
    (g2,) = torch.autograd.grad((g**2).sum(), m.params)
    assert bool(torch.isfinite(g2).all()) and float(g2.abs().sum()) > 0


def test_network_routes_through_identity():
    jmod = tc.Network(3, 2, NET)
    tmod = tt.Network(3, 2, NET, device="cpu")
    assert tmod.model.encoding.hyperparams() == {"otype": "Identity", "scale": 1.0, "offset": 0.0}
    assert tmod.model.network.input_width == 16 and tmod.n_params == jmod.n_params
    _copy_params(jmod, tmod)
    x = _x(4, d=3)
    want = np.asarray(jmod(jnp.asarray(x)))
    got = tmod(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() <= 2.0**-5 * max(1.0, np.abs(want).max())


def test_encoding_module_with_a_grid():
    jmod = tc.Encoding(3, ENC)
    tmod = tt.Encoding(3, ENC, device="cpu")
    _copy_params(jmod, tmod, seed=5)
    x = _x(6, d=3)
    want = np.asarray(jmod(jnp.asarray(x)))
    got = tmod(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, 16)
    assert np.abs(got.detach().numpy() - want).max() <= 2.0**-5 * max(1.0, np.abs(want).max())
    # x.requires_grad: the grid is told needs_input_grad (K7's twin)
    ct = np.random.default_rng(7).normal(size=(B, 16)).astype(np.float32)
    wx = np.asarray(jax.grad(lambda xx: jnp.sum(jmod(xx) * ct))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (gx,) = torch.autograd.grad((tmod(xt) * torch.from_numpy(ct)).sum(), xt)
    assert _rel(gx, wx) < 5e-3
    assert tt.Encoding(3, {"otype": "OneBlob", "n_bins": 4}, device="cpu").n_params == 0


def test_pickle_round_trip(tmp_path):
    m = tt.NetworkWithInputEncoding(2, 3, ENC, NET, seed=3, device="cpu")
    with torch.no_grad():
        m.params.add_(torch.rand(m.n_params, generator=torch.Generator().manual_seed(1)) * 0.1)
    x = torch.from_numpy(_x(8))
    y, ctx = m.fwd(x)  # autograd state that does not travel
    back = pickle.loads(pickle.dumps(m))
    assert type(back) is type(m) and back.device == m.device and back.n_input_dims == 2
    assert torch.equal(back.params, m.params) and back.hyperparams() == m.hyperparams()
    assert torch.equal(back(x), m(x))
    e = pickle.loads(pickle.dumps(tt.Encoding(2, {"otype": "Frequency"}, device="cpu")))
    assert tuple(e(x).shape) == (B, 2 * 12 * 2)


def test_device_defaults_to_the_card_and_exports():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tt.NetworkWithInputEncoding(2, 3, ENC, NET)
    assert tt.batch_size_granularity == tt.BATCH_SIZE_GRANULARITY == 128
    assert [m.value for m in tt.ReductionType] == [m.value for m in tc.ReductionType]
    assert [m.value for m in tt.GradientMode] == [m.value for m in tc.GradientMode]
    m = tt.NetworkWithInputEncoding(2, 3, ENC, NET, device="cpu")
    with pytest.raises(ValueError, match="module on"):
        m(torch.zeros(4, 2, dtype=torch.float32, device="meta"))


def test_modules_sample_learns_on_the_cpu(tmp_path):
    """The sample's demo, training loop and render at 64^2 pixels and a few
    steps on config_hash; no kernel counter moves on CPU tensors."""
    counters = profiling.counts("launches.")
    module = sample.create_module(tt.load_config(str(sample.DEFAULT_CONFIG)), device="cpu")
    image = synthetic_image(64, 64, device="cpu")
    dparams, dx = sample.demo(module, image)
    assert tuple(dparams.shape) == (module.n_params,) and tuple(dx.shape) == (sample.N_DEMO, 2)
    assert float(dparams.abs().sum()) > 0
    losses = sample.train(module, image, 30, batch=4096, log=None)
    assert losses.shape == (30,) and bool(torch.isfinite(losses).all())
    assert float(losses[-5:].mean()) < 0.2 * float(losses[0])
    pred = sample.render(module, 64, 64)
    assert tuple(pred.shape) == (64, 64, 3)
    assert psnr(pred, image) > 12.0
    assert profiling.counts("launches.") == counters


def test_new_modules_import_and_run_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch, tcnn_tpu_torch as tt\n"
        "from tcnn_tpu_torch.samples import mlp_learning_an_image_modules\n"
        "m = tt.create_from_config(2, 3, tt.load_config('data/config_oneblob.json'), device='cpu')\n"
        "assert tuple(m.trainer.inference(torch.rand(129, 2)).shape) == (129, 3)\n"
        "enc = {'otype': 'Composite', 'nested': [{'otype': 'SphericalHarmonics', "
        "'n_dims_to_encode': 3}, {'otype': 'TriangleWave'}]}\n"
        "mod = tt.NetworkWithInputEncoding(5, 1, enc, {'otype': 'CutlassMLP'}, device='cpu')\n"
        "assert tuple(mod(torch.rand(7, 5)).shape) == (7, 1)\n"
        "assert not any(k == 'tcnn_tpu' or k.startswith('tcnn_tpu.') for k in sys.modules)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(sample.ROOT))
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
