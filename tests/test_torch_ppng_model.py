"""The port's PPNG1/2/3 encodings inside models, on the CPU (the twins of
K10-K13): golden vectors, the factory and parameter layout against
tcnn_tpu's, params and snapshots carried over from tcnn_tpu, the Trainer's
route, the launch counters and the encoding's place in
NetworkWithInputEncoding. Parity of the encodings themselves with
tcnn_tpu's routes is in test_torch_ppng.py.

Tolerances: golden N-linear interpolation 1e-5 in f32 from the port's rows
and weights (the golden file's own bound, tests/test_golden.py:256), and
one bf16 rounding (2^-7 relative, 2^-8 absolute) for the encoding's bf16
output; a JAX model's output on its XLA route (f32 tables, XLA MLP) within
2^-5 of the largest output, the bound chip_smoke.py holds the fused MLP
to.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu_torch.models.network_with_input_encoding import NetworkWithInputEncoding
from tcnn_tpu_torch.ops.cuda import train_kernel
from tcnn_tpu_torch.utils import profiling

G = np.load(pathlib.Path(__file__).parent / "golden" / "golden.npz")
KW = {"PPNG1": dict(n_quants=16, n_frequencies=2, n_features=2, rank=2),
      "PPNG2": dict(n_quants=16, n_frequencies=2, n_features=2, rank=2),
      "PPNG3": dict(n_quants=16, n_frequencies=2, n_features=2)}
VARIANTS = tuple(KW)


def test_golden_nlinear_interpolation():
    """PPNG3's N-linear interpolation (interp.h:25-72) against golden.npz,
    as tests/test_golden.py:236-256 checks the JAX package: the port's rows
    and corner weights give the golden output in f32, and the encoding
    itself (bf16 table) within bf16 rounding."""
    sc, feats = G["ni_sc"], G["ni_feats"]
    enc = tt.PPNG3Encoding(3, n_quants=8, n_features=2, n_frequencies=1, log2_min_freq=0,
                           log2_max_freq=0)
    params = np.zeros(enc.n_params, np.float32)
    params[: feats.size] = feats.reshape(-1)
    x = torch.from_numpy((0.5 + np.arcsin(sc) / np.pi).astype(np.float32))
    idx, cw = enc.indices(x)
    rows = torch.from_numpy(params).reshape(-1, 2)[idx.long()]  # [16, 8 corners * 2 levels, 2]
    nl = enc.n_levels
    out = (cw[..., None] * rows).reshape(16, 8, nl, 2).sum(1)[:, 0]  # the sin phase
    np.testing.assert_allclose(out.numpy(), G["ni_out"], atol=1e-5, rtol=1e-5)
    y = enc.apply_unpadded(torch.from_numpy(params), x).float().numpy()[:, :2]
    np.testing.assert_allclose(y, G["ni_out"], rtol=2.0**-7, atol=2.0**-8)


def test_factory_defaults_and_layout():
    for otype in VARIANTS:
        jenc = tc.create_encoding(3, {"otype": otype})
        tenc = tt.create_encoding(3, {"otype": otype})
        assert type(tenc).__name__ == type(jenc).__name__
        assert (tenc.log2_min_freq, tenc.log2_max_freq, tenc.n_quants, tenc.n_frequencies,
                tenc.n_features) == (0, 6, 64, 6, 4)
        assert tenc.rank == (1 if otype == "PPNG3" else 4)
        assert tenc.n_params == jenc.n_params
        assert tenc.n_output_dims == jenc.n_output_dims == 48
        assert tenc.hyperparams() == jenc.hyperparams()
        small = {"otype": otype, "n_quants": 8, "n_frequencies": 3, "n_features": 2,
                 "rank": 2, "log2_max_freq": 4}
        if otype == "PPNG3":
            del small["rank"]
        assert tt.create_encoding(3, small).hyperparams() == tc.create_encoding(3, small).hyperparams()
        assert tt.create_encoding(3, small).n_params == tc.create_encoding(3, small).n_params


@pytest.mark.parametrize("otype", VARIANTS)
def test_validation_errors(otype):
    cls = getattr(tt, otype + "Encoding")
    with pytest.raises(ValueError, match="must be 3"):
        tt.create_encoding(2, {"otype": otype})
    with pytest.raises(ValueError, match="n_features"):
        cls(3, n_features=3)
    with pytest.raises(ValueError, match="rank"):
        cls(3, rank=3)


def test_padded_width_and_init_ranges():
    gen = torch.Generator().manual_seed(0)
    for otype, scale in (("PPNG1", 0.7), ("PPNG2", 0.7), ("PPNG3", 1e-4)):
        cfg = {"otype": otype, **KW[otype], "n_frequencies": 3}
        net = tt.create_network_with_input_encoding(
            3, 1, cfg, {"otype": "FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 1})
        assert net.encoding.n_output_dims == 12 and net.encoding.padded_output_width == 16
        assert net.padded_output_width == 16
        p = net.encoding.init_params(gen)
        assert p.dtype == torch.float32 and p.numel() == net.encoding.n_params
        assert float(p.abs().max()) <= scale and float(p.abs().max()) > 0.9 * scale
        y = net.encoding.apply(p, torch.rand(5, 3, generator=gen))
        assert y.dtype == torch.bfloat16 and y.shape == (5, 16)
        assert not bool(y[:, 12:].any())


def _config(otype, n_neurons=16):
    return {"loss": {"otype": "L2"}, "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
            "encoding": {"otype": otype, **KW[otype]},
            "network": {"otype": "FullyFusedMLP", "n_neurons": n_neurons, "n_hidden_layers": 2}}


@pytest.mark.parametrize("otype", VARIANTS)
def test_params_from_jax_give_the_same_model(otype, tmp_path):
    """A tcnn_tpu PPNG model's flat [network | encoding] params carried by
    params_from_jax: the port's output agrees with the JAX model's (its XLA
    route on the CPU: f32 tables, so within 2^-5 of the largest output) and
    a JAX snapshot loads in the port with the same predictions."""
    cfg = _config(otype)
    jm = tc.create_from_config(3, 1, cfg)
    tm = tt.create_from_config(3, 1, cfg, device="cpu")
    p = np.asarray(jm.trainer.params).copy()
    assert p.size == tm.network.n_params
    tm.trainer.set_params(tt.params_from_jax(p, tm.network.n_params))
    x = np.random.default_rng(7).uniform(0, 1, (200, 3)).astype(np.float32)
    want = np.asarray(jm.network.apply(jnp.asarray(p), jnp.asarray(x)).astype(jnp.float32))
    got = tm.network.apply(tm.trainer.params, torch.from_numpy(x)).float().numpy()
    assert np.abs(got - want).max() <= 2.0**-5 * max(1.0, np.abs(want).max())
    path = tmp_path / "snapshot.json"
    jm.trainer.save(str(path))
    fresh = tt.create_from_config(3, 1, cfg, seed=5, device="cpu")
    fresh.trainer.load(str(path))
    assert torch.equal(fresh.trainer.params, tm.trainer.params)


@pytest.mark.parametrize("otype", VARIANTS)
def test_port_snapshot_loads_in_jax(otype, tmp_path):
    """The reverse of test_params_from_jax_give_the_same_model: the port
    trains two steps and saves with its optimizer block; tcnn_tpu's Trainer
    loads it with the same params and Adam state and predicts what the
    port predicts (its XLA route: within 2^-5 of the largest output)."""
    cfg = _config(otype)
    tm = tt.create_from_config(3, 1, cfg, seed=9, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for _ in range(2):
        x = torch.rand(256, 3, generator=gen)
        tm.trainer.training_step(x, (x - 0.5).norm(dim=-1, keepdim=True) - 0.3)
    path = str(tmp_path / "port.json")
    tm.trainer.save(path)
    jm = tc.create_from_config(3, 1, cfg)
    jm.trainer.load(path)
    np.testing.assert_array_equal(np.asarray(jm.trainer.params), tm.trainer.params.numpy())
    for k, v in jm.trainer.state["opt"].items():
        np.testing.assert_array_equal(np.asarray(v), tm.trainer.state["opt"][k].numpy())
    x = np.random.default_rng(8).uniform(0, 1, (200, 3)).astype(np.float32)
    want = np.asarray(jm.trainer.inference(jnp.asarray(x)), np.float32)
    got = tm.trainer.inference(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 2.0**-5 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("otype", VARIANTS)
def test_trainer_takes_the_composed_route(otype):
    """No fused kernel takes a PPNG model: training and inference run
    model.apply (the encoding's gathers, then K2/K5's twins), and the loss
    falls."""
    tm = tt.create_from_config(3, 1, _config(otype), device="cpu")
    assert train_kernel.fused_plan_for(tm.network) is None
    assert not tm.trainer.use_fused() and not train_kernel.supported_ig(tm.network)
    gen = torch.Generator().manual_seed(3)
    x = torch.rand(256, 3, generator=gen)
    t = (x - 0.5).norm(dim=-1, keepdim=True) - 0.3
    losses = [float(tm.trainer.training_step(x, t)) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    y = tm.trainer.inference(x[:100])
    assert torch.equal(y, tm.network.apply(tm.trainer.params, x[:100])[:, :1].float())


def _counters():
    return profiling.counts("launches.")


@pytest.mark.parametrize("otype", VARIANTS)
def test_cpu_model_launches_no_kernel(otype):
    """A whole eikonal step of a PPNG model on CPU tensors takes only the
    twins: no counter of K1-K13 moves."""
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    tm = tt.create_from_config(3, 1, _config(otype), device="cpu")
    before = _counters()
    loss, grads = sdf.loss_and_grad(tm.trainer, torch.rand(256, 3))
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(grads).all())
    assert _counters() == before


def test_count_binned_drops_is_zero():
    enc = tt.PPNG3Encoding(3, **KW["PPNG3"])
    assert enc.count_binned_drops(torch.rand(100, 3)) == 0


def test_max_level_is_accepted_and_ignored():
    enc = tt.PPNG2Encoding(3, **KW["PPNG2"])
    p = enc.init_params(torch.Generator().manual_seed(0))
    x = torch.rand(10, 3)
    assert torch.equal(enc.apply(p, x, max_level=0.25), enc.apply(p, x))


def test_input_gradients_of_an_encoding_without_needs_input_grad():
    """NetworkWithInputEncoding tells only an encoding that declares
    supports_input_grad_opt (the grid) about needs_input_grad, as the JAX
    package does (network_with_input_encoding.py:93-94); any other encoding
    is differentiable in x as it is and is called without it."""
    from tcnn_tpu_torch.ops.encodings.base import Encoding

    class Scale(Encoding):
        """x * s, an encoding whose apply takes no keyword."""

        pad_value = 0.0

        @property
        def n_output_dims(self):
            return 3

        @property
        def n_params(self):
            return 1

        def init_params(self, generator):
            return torch.ones(1)

        def apply_unpadded(self, params, x, **_):
            return (x * params).to(torch.bfloat16)

        def hyperparams(self):
            return {"otype": "Scale"}

    net = NetworkWithInputEncoding(
        Scale(3), lambda enc: tt.create_network(enc.padded_output_width, 1, {
            "otype": "FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 1}))
    assert tt.GridEncoding.supports_input_grad_opt
    assert not getattr(net.encoding, "supports_input_grad_opt", False)
    p = net.init_params(torch.Generator().manual_seed(0)).requires_grad_(True)
    x = torch.rand(7, 3, requires_grad=True)
    out = net.apply(p, x, prepare_input_gradients=True)
    (g,) = torch.autograd.grad(out[:, 0].float().sum(), x, create_graph=True)
    (g2,) = torch.autograd.grad((g * g).sum(), p)
    assert g.shape == (7, 3) and bool(torch.isfinite(g2).all()) and bool(g2.abs().sum() > 0)


@pytest.mark.parametrize("otype", VARIANTS)
def test_third_derivative_through_the_encoding(otype):
    """d/dx of d/dparams of |dy/dx|^2: the encodings compose to third order
    (the JAX package's dense-ext route does too), on the twins."""
    enc = getattr(tt, otype + "Encoding")(3, **KW[otype])
    gen = torch.Generator().manual_seed(4)
    p = (torch.rand(enc.n_params, generator=gen) * 1.4 - 0.7).requires_grad_(True)
    x = torch.rand(64, 3, generator=gen).requires_grad_(True)
    (g,) = torch.autograd.grad(enc.apply(p, x).float().sum(), x, create_graph=True)
    (h,) = torch.autograd.grad((g * g).sum(), p, create_graph=True)
    (k,) = torch.autograd.grad((h * h).sum(), x)
    assert bool(torch.isfinite(k).all()) and float(k.abs().sum()) > 0
