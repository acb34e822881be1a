"""The port's fixed-function encodings (tcnn_tpu_torch/ops/encodings/fixed.py)
and quartic CDF against tcnn_tpu on the CPU. Neither package has a kernel
for them: both are plain array code, so the same seeded numpy inputs go
through `apply_unpadded(..., compute_dtype=jnp.float32)` and the port's
`encode_f32`.

Tolerances:
  - f32 values: 1e-5 absolute. Both compute in f32 in the same op order;
    TriangleWave, OneBlob, Identity and SH agree bit for bit. Frequency's
    argument reaches 2^11 pi (12 frequencies), where one f32 ulp of the
    argument is 2^-11, but both packages form it in the same two f32
    roundings, so only the sin/cos implementations differ, each within a
    few ulp of 1: 1e-5 holds for it too (measured 6e-8).
  - bf16 outputs: at most one bf16 ulp (2^-7 relative) apart, which a
    1e-5 difference in f32 can flip.
  - input gradients against jax.grad: norm-relative 1e-5. Each is a sum
    over the input's outputs, differentiated by each package's autodiff in
    its own order; the terms of Frequency and TriangleWave carry 2^k and
    OneBlob's n_bins, and cancel (measured: SH and Identity bit-equal,
    Frequency 8.7e-8, TriangleWave 8.6e-8, OneBlob 7.4e-7 and 1.7e-6).
  - SH against golden.npz with test_golden.py:125-141's bounds: values
    2e-5 absolute, gradients 3e-4 absolute + 1e-4 relative; the quartic CDF
    and its derivative 1e-6 absolute (test_golden.py:145-154).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu.common import quartic_cdf as jax_quartic_cdf
from tcnn_tpu_torch.common import quartic_cdf, quartic_cdf_deriv
from tcnn_tpu_torch.ops.encodings import fixed

G = np.load(pathlib.Path(__file__).parent / "golden" / "golden.npz")

CASES = [
    ("Frequency", 3, {"n_frequencies": 12}),
    ("TriangleWave", 3, {"n_frequencies": 12}),
    ("OneBlob", 2, {"n_bins": 64}),
    ("OneBlob", 5, {"n_bins": 4}),
    ("Identity", 4, {"scale": 2.5, "offset": -0.3}),
    ("SphericalHarmonics", 3, {"degree": 4}),
    ("SphericalHarmonics", 3, {"degree": 8}),
]
IDS = [f"{o}-{d}-{list(c.values())}" for o, d, c in CASES]


def _pair(otype, d, cfg, seed):
    je = tc.create_encoding(d, {"otype": otype, **cfg})
    te = tt.create_encoding(d, {"otype": otype, **cfg})
    x = np.random.default_rng(seed).uniform(0, 1, (1000, d)).astype(np.float32)
    return je, te, x


@pytest.mark.parametrize("otype,d,cfg", CASES, ids=IDS)
def test_values_and_input_gradients_match_jax(otype, d, cfg):
    je, te, x = _pair(otype, d, cfg, seed=len(otype) + d)
    assert type(te).__name__ == type(je).__name__
    assert te.n_output_dims == je.n_output_dims and te.hyperparams() == je.hyperparams()
    want = np.asarray(je.apply_unpadded(None, jnp.asarray(x), compute_dtype=jnp.float32))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = te.encode_f32(xt)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    # bf16: the JAX default compute dtype against the port's apply_unpadded
    wb = np.asarray(je.apply_unpadded(None, jnp.asarray(x)).astype(jnp.float32))
    gb = te.apply_unpadded(None, torch.from_numpy(x))
    assert gb.dtype == torch.bfloat16
    gb = gb.float().numpy()
    assert (np.abs(gb - wb) <= 2.0**-7 * np.maximum(np.abs(gb), np.abs(wb))).all()
    # input gradients of a seeded cotangent
    ct = np.random.default_rng(7).normal(size=want.shape).astype(np.float32)
    jg = np.asarray(jax.grad(lambda xx: jnp.sum(
        je.apply_unpadded(None, xx, compute_dtype=jnp.float32) * ct))(jnp.asarray(x)))
    (tg,) = torch.autograd.grad((got * torch.from_numpy(ct)).sum(), xt, materialize_grads=True)
    assert np.linalg.norm(tg.numpy() - jg) <= 1e-5 * np.linalg.norm(jg)


@pytest.mark.parametrize("degree", range(1, 9))
def test_spherical_harmonics_golden(degree):
    """sh_encode against the reference's polynomial table (golden.npz), as
    tests/test_golden.py:125-141 holds the JAX package."""
    enc = tt.create_encoding(3, {"otype": "SphericalHarmonics", "degree": degree})
    dirs = torch.from_numpy(G["sh_dirs"]).requires_grad_(True)
    y = enc.encode_f32(dirs)
    np.testing.assert_allclose(y.detach().numpy(), G[f"sh_out_deg{degree}"], atol=2e-5)
    dl = torch.from_numpy(G[f"sh_dl_deg{degree}"][:, 0])
    if degree == 1:  # a constant: no graph, zero gradient
        assert not y.requires_grad and not G["sh_grad_deg1"].any()
        return
    (g,) = torch.autograd.grad((y * dl[None]).sum(), dirs)
    np.testing.assert_allclose(g.numpy(), G[f"sh_grad_deg{degree}"], atol=3e-4, rtol=1e-4)
    # sh_encode itself takes the direction in [-1, 1]
    assert torch.equal(fixed.sh_encode(dirs.detach() * 2.0 - 1.0, degree), y.detach())


def test_quartic_cdf_golden_and_against_jax():
    x = torch.from_numpy(G["qc_x"][:, 0])
    np.testing.assert_allclose(quartic_cdf(x, 0.1).numpy(), G["qc_cdf"][:, 0], atol=1e-6)
    np.testing.assert_allclose(quartic_cdf_deriv(x, 0.1).numpy(), G["qc_pdf"][:, 0], atol=1e-6)
    # the clamp's gradient is zero outside the support, as jnp.clip's is
    t = np.linspace(-0.3, 0.3, 61, dtype=np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jax_quartic_cdf(v, 8)))(jnp.asarray(t)))
    tt_ = torch.from_numpy(t).requires_grad_(True)
    (got,) = torch.autograd.grad(quartic_cdf(tt_, 8).sum(), tt_)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert not got[np.abs(t) > 1 / 8 + 1e-6].any()
    np.testing.assert_allclose(got.detach().numpy(), quartic_cdf_deriv(tt_.detach(), 8).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("otype,d,cfg", CASES, ids=IDS)
def test_padding_front_for_sh_back_for_the_rest(otype, d, cfg):
    je, te, x = _pair(otype, d, cfg, seed=3)
    for e in (je, te):
        e.set_alignment(16)
    assert te.padded_output_width == je.padded_output_width
    want = np.asarray(je.apply(None, jnp.asarray(x)).astype(jnp.float32))
    got = te.apply(None, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    got = got.float().numpy()
    pad = te.n_to_pad
    if pad:
        cols = slice(0, pad) if otype == "SphericalHarmonics" else slice(te.n_output_dims, None)
        assert (got[:, cols] == 1.0).all() and (want[:, cols] == 1.0).all()
    assert (np.abs(got - want) <= 2.0**-7 * np.maximum(np.abs(got), np.abs(want))).all()


def test_empty_and_validation():
    e = tt.create_encoding(3, {"otype": "Empty"})
    x = torch.rand(5, 3, requires_grad=True)
    assert e.n_output_dims == 0 and tuple(e.apply(None, x).shape) == (5, 0)
    e.set_alignment(4)
    assert e.padded_output_width == 0
    with pytest.raises(ValueError, match="3 input dims"):
        tt.create_encoding(2, {"otype": "SphericalHarmonics"})
    with pytest.raises(ValueError, match=r"\[1, 8\]"):
        tt.create_encoding(3, {"otype": "SphericalHarmonics", "degree": 9})


def test_factory_defaults_match_jax():
    for otype, attr, value in (("Frequency", "n_frequencies", 12), ("OneBlob", "n_bins", 16),
                               ("SphericalHarmonics", "degree", 4),
                               ("TriangleWave", "n_frequencies", 12)):
        te = tt.create_encoding(3, {"otype": otype})
        je = tc.create_encoding(3, {"otype": otype})
        assert getattr(te, attr) == getattr(je, attr) == value
    # OneBlob is create_encoding's default otype, as in the JAX package
    assert type(tt.create_encoding(2, {})).__name__ == "OneBlobEncoding"


def test_every_jax_encoding_otype_is_registered():
    from tcnn_tpu import registry as jax_registry
    from tcnn_tpu_torch import registry

    assert set(jax_registry._ENCODING_FACTORIES) <= set(registry._ENCODING_FACTORIES)


def test_set_padded_output_width_and_alignment():
    """set_padded_output_width fixes the width; set_alignment clears it, as
    the JAX base does (base.py:65). The grid and PPNG read the width."""
    for cfg in ({"otype": "OneBlob", "n_bins": 8},
                {"otype": "HashGrid", "n_levels": 4, "log2_hashmap_size": 10},
                {"otype": "PPNG3", "n_quants": 16, "n_frequencies": 2, "n_features": 2}):
        te, je = tt.create_encoding(3, cfg), tc.create_encoding(3, cfg)
        w = te.n_output_dims + 3
        for e in (te, je):
            e.set_padded_output_width(w)
        assert te.padded_output_width == je.padded_output_width == w
        p = te.init_params(torch.Generator().manual_seed(0))
        y = te.apply(p, torch.rand(130, 3))
        assert tuple(y.shape) == (130, w) and (y[:, te.n_output_dims:].float() == te.pad_value).all()
        te.set_alignment(16)
        assert te.padded_output_width == max(16, -(-te.n_output_dims // 16) * 16)
        with pytest.raises(ValueError, match="padded width"):
            te.set_padded_output_width(te.n_output_dims - 1)
