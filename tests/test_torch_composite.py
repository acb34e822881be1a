"""The port's Composite encoding (tcnn_tpu_torch/ops/encodings/composite.py)
and its registry rules against tcnn_tpu on the CPU, with a hash grid nested
at a padded width that is not a multiple of F.

  - Concatenation, Sum and Product of fixed encodings against the JAX
    Composite: the f32 nested values agree within 1e-5 (the fixed
    encodings' bound, test_torch_fixed_encodings.py), so the bf16 outputs
    are at most one bf16 ulp (2^-7 relative) apart;
  - a grid nested last at an odd padded width (Identity 3 + grid 32 padded
    to 48: the grid at 45; SH 9 + grid 32: the grid at 39, path (c) of the
    card's phase 16) against the JAX package's nested encodings, its grid
    through its Pallas forward in interpret mode as
    test_torch_k1_widths.py runs it: one bf16 ulp;
  - the input gradient and its second order (the vjp of the vjp) through
    the Composite against the JAX Composite's on its XLA route (f32 table)
    with tests/test_torch_grid_ig.py's bound against XLA: 5e-3
    norm-relative. Through a whole model the bf16 MLP chain rounds every
    layer's activations and cotangents in each package's own order, which
    moves the input gradient of a plain grid model 2-7% as well, so the
    model is held to the same model composed by hand in the port, bit for
    bit, and to the JAX model's forward;
  - the fused gates refuse Composite and OneBlob models.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu_torch.ops.cuda import train_kernel

GRID = {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2,
        "log2_hashmap_size": 12, "base_resolution": 4, "per_level_scale": 1.5}
#: path (c)'s shape: SH of degree 3 on dims 3-5, then a 3-D grid on dims 0-2
SH_GRID = {"otype": "Composite", "nested": [
    {"otype": "SphericalHarmonics", "degree": 3, "n_dims_to_encode": 3,
     "dims_to_encode_begin": 3},
    {**GRID, "n_dims_to_encode": 3, "dims_to_encode_begin": 0}]}
#: the ROADMAP's case: a 3-wide prefix, then the grid on the remainder
ID_GRID = {"otype": "Composite", "nested": [
    {"otype": "Identity", "n_dims_to_encode": 3}, dict(GRID)]}
NET = {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2}


def _rel(got, want):
    got, want = np.asarray(got, np.float64).ravel(), np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _ulp_apart(got, want):
    return np.abs(got - want) <= 2.0**-7 * np.maximum(np.abs(got), np.abs(want))


@pytest.mark.parametrize("reduction", ["Concatenation", "Sum", "Product"])
def test_reductions_match_jax(reduction):
    cfg = {"otype": "Composite", "reduction": reduction, "nested": [
        {"otype": "Frequency", "n_frequencies": 2, "n_dims_to_encode": 2},
        {"otype": "OneBlob", "n_bins": 4, "n_dims_to_encode": 1},
        {"otype": "TriangleWave", "n_frequencies": 4}]}
    if reduction == "Concatenation":
        cfg["nested"][1]["n_bins"] = 5
    else:  # equal widths: 2 * 2 * 2 = 8 = 2 * 4 = 2 * 4
        cfg["nested"][1].update(n_bins=4, n_dims_to_encode=2)
    je, te = tc.create_encoding(6, cfg, alignment=16), tt.create_encoding(6, cfg, alignment=16)
    assert type(te).__name__ == "CompositeEncoding" and te.hyperparams() == je.hyperparams()
    assert (te.n_output_dims, te.padded_output_width, te.n_params) == (
        je.n_output_dims, je.padded_output_width, je.n_params)
    x = np.random.default_rng(1).uniform(0, 1, (300, 6)).astype(np.float32)
    want = np.asarray(je.apply(jnp.zeros(0), jnp.asarray(x)).astype(jnp.float32))
    got = te.apply(torch.zeros(0), torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert want.shape == (300, 32 if reduction == "Concatenation" else 16)
    assert _ulp_apart(got.float().numpy(), want).all()
    if reduction == "Sum":  # each nested encoding pads with 1; the padding sums
        assert (got[:, 8:].float() == 3.0).all()


def test_dims_to_encode_rules():
    """composite.h:147-188: begins, one inferred remainder, the errors."""
    te = tt.create_encoding(7, {"otype": "Composite", "nested": [
        {"otype": "Identity", "n_dims_to_encode": 2, "dims_to_encode_begin": 4},
        {"otype": "OneBlob", "n_bins": 2, "n_dims_to_encode": 3, "dims_to_encode_begin": 0}]})
    assert te.dims_to_encode_begin == [4, 0] and [e.n_dims_to_encode for e in te.nested] == [2, 3]
    x = torch.rand(5, 7)
    assert torch.equal(te.apply(torch.zeros(0), x)[:, :2], x[:, 4:6].to(torch.bfloat16))
    te = tt.create_encoding(7, {"otype": "Composite", "nested": [
        {"otype": "Identity", "n_dims_to_encode": 2}, {"otype": "Frequency"},
        {"otype": "Identity", "n_dims_to_encode": 1}]})
    assert te.dims_to_encode_begin == [0, 2, 6] and te.nested[1].n_dims_to_encode == 4
    # a nested encoding of 0 dims drops out, as in the JAX registry
    te = tt.create_encoding(3, {"otype": "Composite", "nested": [
        {"otype": "Identity", "n_dims_to_encode": 3}, {"otype": "OneBlob"}]})
    assert len(te.nested) == 1
    bad = [({"nested": []}, "array of nested"),
           ({"nested": [{"otype": "Identity"}, {"otype": "OneBlob"}]}, "single nested"),
           ({"nested": [{"otype": "Identity", "n_dims_to_encode": 5}]}, "more dims"),
           ({"reduction": "Sum", "nested": [{"otype": "Identity", "n_dims_to_encode": 1},
                                            {"otype": "OneBlob", "n_dims_to_encode": 2}]},
            "equal nested output widths")]
    for cfg, match in bad:
        with pytest.raises(ValueError, match=match):
            tt.create_encoding(4, {"otype": "Composite", **cfg})
        with pytest.raises(ValueError):
            tc.create_encoding(4, {"otype": "Composite", **cfg})


def test_nested_encodings_get_contiguous_slices():
    """The kernels refuse a strided x on the card, so each nested encoding
    gets its slice contiguous, and a grid nested last gets needs_input_grad;
    each gets the compute dtype."""
    te = tt.create_encoding(6, SH_GRID)
    seen = []
    for enc in te.nested:
        apply = enc.apply

        def spy(p, x, _apply=apply, **kw):
            seen.append((x.is_contiguous(), tuple(x.shape), kw))
            return _apply(p, x, **kw)

        enc.apply = spy
    p = te.init_params(torch.Generator().manual_seed(0))
    te.apply(p, torch.rand(10, 6, requires_grad=True), needs_input_grad=True)
    bf16 = {"compute_dtype": torch.bfloat16}
    assert seen == [(True, (10, 3), bf16), (True, (10, 3), {"needs_input_grad": True, **bf16})]


@pytest.mark.parametrize("otype", ["NRC", "OneBlobFrequency"])
def test_nrc_preset(otype):
    te = tt.create_encoding(10, {"otype": otype})
    je = tc.create_encoding(10, {"otype": otype})
    assert te.n_output_dims == 3 * 12 + 5 * 4 + 2 == je.n_output_dims
    assert [e.hyperparams() for e in te.nested] == [e.hyperparams() for e in je.nested]
    assert te.dims_to_encode_begin == je.dims_to_encode_begin == [0, 3, 8]


def _jax_nested_pallas(je, p, x):
    """The JAX Composite's concatenation, its grid through the Pallas
    forward (interpret mode), as tests/test_torch_k1_widths.py runs it."""
    outs, off = [], 0
    for enc, begin in zip(je.nested, je.dims_to_encode_begin):
        pp, off = p[off: off + enc.n_params], off + enc.n_params
        xi = jnp.asarray(x[:, begin: begin + enc.n_dims_to_encode])
        kw = {"impl": "pallas", "needs_input_grad": False} if enc.n_params else {}
        outs.append(enc.apply(jnp.asarray(pp), xi, **kw))
    return np.asarray(jnp.concatenate(outs, -1).astype(jnp.float32))


@pytest.mark.parametrize("cfg,d,grid_width", [(ID_GRID, 6, 45), (SH_GRID, 6, 39)],
                         ids=["identity-45", "sh-39"])
def test_grid_at_odd_padded_width_matches_jax(cfg, d, grid_width):
    je, te = tc.create_encoding(d, cfg, alignment=16), tt.create_encoding(d, cfg, alignment=16)
    grid = te.nested[-1]
    assert grid.padded_output_width == je.nested[-1].padded_output_width == grid_width
    assert grid_width % grid.n_features_per_level and te.padded_output_width == 48
    rng = np.random.default_rng(grid_width)
    p = rng.uniform(-1, 1, je.n_params).astype(np.float32)
    x = rng.uniform(0, 1, (257, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = _jax_nested_pallas(je, p, x)
    got = te.apply(torch.from_numpy(p), torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape == (257, 48)
    got = got.float().numpy()
    assert _ulp_apart(got, want).all()
    assert not got[:, 48 - grid_width + 32:].any()  # the grid pads with zeros
    # and the JAX Composite itself on its XLA route (f32 table): 2^-5
    xla = np.asarray(je.apply(jnp.asarray(p), jnp.asarray(x)).astype(jnp.float32))
    assert np.abs(got - xla).max() <= 2.0**-5 * max(1.0, np.abs(xla).max())


def test_second_order_input_gradient_matches_jax():
    """The vjp of the Composite (SH 9 + grid at 39) and the vjp of that vjp
    against the JAX Composite's (its grid on the XLA route)."""
    je, te = tc.create_encoding(6, SH_GRID, alignment=16), tt.create_encoding(6, SH_GRID, alignment=16)
    rng = np.random.default_rng(5)
    p = rng.uniform(-1, 1, je.n_params).astype(np.float32)
    x = rng.uniform(0, 1, (200, 6)).astype(np.float32)
    gy = np.array(jnp.asarray(rng.normal(size=(200, 48)), jnp.bfloat16).astype(jnp.float32))
    z = rng.normal(size=(200, 6)).astype(np.float32)
    ct = rng.normal(size=je.n_params).astype(np.float32)

    def bwd(pp, xx, gg):
        return jax.vjp(lambda a, b: je.apply(a, b, compute_dtype=jnp.float32), pp, xx)[1](gg)

    (jg, jx), vjp2 = jax.vjp(bwd, jnp.asarray(p), jnp.asarray(x), jnp.asarray(gy))
    jcp, jcx, _ = vjp2((jnp.asarray(ct), jnp.asarray(z)))
    params = torch.from_numpy(p).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = te.apply(params, xt, needs_input_grad=True)
    gp, gx = torch.autograd.grad(y, (params, xt), torch.from_numpy(gy).to(torch.bfloat16),
                                 create_graph=True)
    cp, cx = torch.autograd.grad((gp, gx), (params, xt), (torch.from_numpy(ct), torch.from_numpy(z)))
    for got, want in ((gp, jg), (gx, jx), (cp, jcp), (cx, jcx)):
        assert _rel(got.detach().numpy(), np.asarray(want)) < 5e-3


def _models(cfg=SH_GRID, seed=0):
    jm = tc.create_network_with_input_encoding(6, 1, cfg, NET)
    tm = tt.create_network_with_input_encoding(6, 1, cfg, NET)
    p = np.asarray(jm.init_params(jax.random.PRNGKey(seed))).copy()
    n_net = jm.network.n_params
    p[n_net:] = np.random.default_rng(seed).uniform(-1, 1, p.size - n_net)
    return jm, tm, p


def test_model_forward_and_second_order():
    jm, tm, p = _models()
    assert tm.n_params == jm.n_params == p.size and tm.encoding.padded_output_width == 48
    params = tt.params_from_jax(p, tm.n_params)
    x = np.random.default_rng(6).uniform(0, 1, (200, 6)).astype(np.float32)
    want = np.asarray(jm.apply(jnp.asarray(p), jnp.asarray(x)).astype(jnp.float32))
    got = tm.apply(params, torch.from_numpy(x)).float().numpy()
    assert np.abs(got - want).max() <= 2.0**-5 * max(1.0, np.abs(want).max())

    def eikonal(apply_enc):
        pp = params.clone().requires_grad_(True)
        xx = torch.from_numpy(x).requires_grad_(True)
        net_p, enc_p = tm.split_params(pp)
        out = tm.network.apply(net_p, apply_enc(enc_p, xx), second_order=True)
        (g,) = torch.autograd.grad(out[:, 0].float().sum(), xx, create_graph=True)
        return (g.detach(), *torch.autograd.grad(((g.norm(dim=-1) - 1) ** 2).mean(), (pp, xx)))

    def by_hand(enc_p, xx):  # the nested encodings concatenated by hand
        sh, grid = tm.encoding.nested
        return torch.cat([sh.apply(enc_p[:0], xx[:, 3:]),
                          grid.apply(enc_p, xx[:, :3], needs_input_grad=True)], -1)

    composite = eikonal(lambda e, xx: tm.encoding.apply(e, xx, needs_input_grad=True))
    for a, b in zip(composite, eikonal(by_hand)):
        assert torch.equal(a, b)
    # NetworkWithInputEncoding hands prepare_input_gradients down as needs_input_grad
    xx = torch.from_numpy(x).requires_grad_(True)
    out = tm.apply(params, xx, prepare_input_gradients=True)
    (g,) = torch.autograd.grad(out[:, 0].float().sum(), xx)
    assert torch.equal(g, composite[0])
    with pytest.raises(NotImplementedError, match="needs_input_grad"):
        tm.apply(params, torch.from_numpy(x).requires_grad_(True))
    with pytest.raises(TypeError, match="max_level"):
        tm.apply(params, torch.from_numpy(x), max_level=0.5)


def test_params_from_jax_and_training_step():
    """A JAX Composite model's params carry over; the port's Trainer takes
    the composed route (no fused gate takes a Composite) and the loss falls."""
    cfg = {"loss": {"otype": "L2"}, "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
           "encoding": SH_GRID, "network": NET}
    tm = tt.create_from_config(6, 1, cfg, device="cpu")
    jm = tc.create_from_config(6, 1, cfg)
    tm.trainer.set_params(tt.params_from_jax(np.asarray(jm.trainer.params), tm.network.n_params))
    assert train_kernel.fused_plan_for(tm.network) is None
    assert not train_kernel.supported(tm.network, tm.trainer.loss_fn)
    assert not train_kernel.supported_ig(tm.network) and not tm.trainer.use_fused()
    gen = torch.Generator().manual_seed(2)
    x = torch.rand(256, 6, generator=gen)
    t = x[:, :1] * x[:, 3:4]
    losses = [float(tm.trainer.training_step(x, t)) for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    y = tm.trainer.inference(x[:100])
    assert torch.equal(y, tm.network.apply(tm.trainer.params, x[:100])[:, :1].float())


def test_gates_refuse_oneblob():
    m = tt.create_from_config(2, 3, tt.load_config("data/config_oneblob.json"), device="cpu")
    assert train_kernel.fused_plan_for(m.network) is None
    assert not train_kernel.supported(m.network, m.trainer.loss_fn)
    assert not train_kernel.supported_ig(m.network) and not m.trainer.use_fused()
