"""The port's PPNG1/2/3 encodings (tcnn_tpu_torch/ops/encodings/ppng.py) on
the CPU, through the plain twins of K10-K13, against tcnn_tpu's encodings
on both of its routes: impl="xla" (PPNG1's one-hot einsum, PPNG2's einsum,
PPNG3's gather; f32 tables) and impl="pallas" (the dense-ext kernels in
interpret mode; bf16 tables; PPNG1 has no Pallas route and runs its einsum
there too). Small shapes: Q = 16, two frequencies, O(1) params drawn with
numpy (U(+-1e-4) would hide bf16 differences).

The coordinates are computed in each framework, and torch's sin and XLA's
differ by an ulp on ~5% of arguments; where sin is flat (p near 0 or
Q - 1) that can move floor(p) by one (measured: 12 of 10^5 samples at
these shapes). Such samples are counted (COORD_DIFF_MAX) and left out of
the exact forward check; the gradients' norms carry them.

Tolerances (norm-relative for gradients):
  - the forward against the same-precision route (PPNG1 on either route,
    PPNG2/3 on the Pallas route): bit-equal on samples whose coordinates
    agree, but for PPNG1 one bf16 rounding of the f32 sum may flip (its
    einsum and the port's lerp round in other places; measured bit-equal);
  - gradients against that route 1e-4: the weights carry the sin's ulp
    differences, which flip the bf16 rounding of a few scattered
    contributions (measured up to 1.9e-5); unrounded contributions would
    read ~1e-3;
  - against the XLA route of PPNG2/3, which reads f32 tables where the port
    and the TPU route read bf16: forward 5e-3 of the largest output,
    gradients 2e-2 (the bounds of tests/test_ppng.py; measured up to 4.5e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tcnn_tpu.ops.encodings import ppng as jppng
from tcnn_tpu_torch.ops.encodings import ppng as tppng

B = 256
KW = {"PPNG1": dict(n_quants=16, n_frequencies=2, n_features=2, rank=2),
      "PPNG2": dict(n_quants=16, n_frequencies=2, n_features=2, rank=2),
      "PPNG3": dict(n_quants=16, n_frequencies=2, n_features=2)}
VARIANTS = tuple(KW)
#: Samples (of B) whose quantized coordinates may differ between the two
#: frameworks' sin (expected 0 at B = 256: 1.2e-4 per sample measured).
COORD_DIFF_MAX = 2
GRAD_TIGHT = 1e-4
GRAD_XLA = 2e-2


def _rel(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _encodings(variant):
    return (getattr(jppng, variant + "Encoding")(3, **KW[variant]),
            getattr(tppng, variant + "Encoding")(3, **KW[variant]))


def _inputs(variant, je):
    seed = VARIANTS.index(variant)
    rng = np.random.default_rng(seed)
    p = (rng.normal(size=je.n_params) * 0.7).astype(np.float32)
    x = rng.uniform(0.02, 0.98, (B, 3)).astype(np.float32)
    ct = rng.normal(size=(B, je.n_output_dims)).astype(np.float32)
    return p, x, ct


def _port(te, p, x, ct):
    """Forward, d sum(y * ct) / d(params, x), and the eikonal second order
    d sum(|d sum(y) / dx|^2) / d params, through the port's twins."""
    pt, xt = torch.from_numpy(p).requires_grad_(True), torch.from_numpy(x).requires_grad_(True)
    y = te.apply_unpadded(pt, xt)
    gp, gx = torch.autograd.grad((y.float() * torch.from_numpy(ct)).sum(), (pt, xt),
                                 retain_graph=True)
    (g,) = torch.autograd.grad(y.float().sum(), xt, create_graph=True)
    (g2,) = torch.autograd.grad((g * g).sum(), pt)
    return {"forward": y.detach().float().numpy(), "params": gp.numpy(), "input": gx.numpy(),
            "eikonal": g2.numpy()}


def _jax(je, p, x, ct, impl):
    pj, xj = jnp.asarray(p), jnp.asarray(x)

    def apply(pp, xx):
        return je.apply_unpadded(pp, xx, impl=impl).astype(jnp.float32)

    def eik(pp):
        g = jax.grad(lambda xx: jnp.sum(apply(pp, xx)))(xj)
        return jnp.sum(g * g)

    gp, gx = jax.grad(lambda pp, xx: jnp.sum(apply(pp, xx) * ct), argnums=(0, 1))(pj, xj)
    return {"forward": np.asarray(apply(pj, xj)), "params": np.asarray(gp),
            "input": np.asarray(gx), "eikonal": np.asarray(jax.grad(eik)(pj))}


_CACHE = {}


def _results(variant):
    """(port, {route: jax}, samples whose coordinates differ), computed once."""
    if variant not in _CACHE:
        je, te = _encodings(variant)
        p, x, ct = _inputs(variant, je)
        want = {"xla": _jax(je, p, x, ct, "xla")}
        with pltpu.force_tpu_interpret_mode():
            want["pallas"] = _jax(je, p, x, ct, "pallas")
        a0, a1, _ = je._quant_coords(jnp.asarray(x))
        b0, b1, _ = te._quant_coords(torch.from_numpy(x))
        differ = ((np.asarray(a0) != b0.numpy()) | (np.asarray(a1) != b1.numpy()))
        _CACHE[variant] = (_port(te, p, x, ct), want, differ.reshape(B, -1).any(axis=1))
    return _CACHE[variant]


def _tight(variant, route) -> bool:
    """Whether the JAX route reads the table in the port's precision."""
    return variant == "PPNG1" or route == "pallas"


@pytest.mark.parametrize("variant", VARIANTS)
def test_quantized_coordinates_agree(variant):
    _, _, differ = _results(variant)
    assert int(differ.sum()) <= COORD_DIFF_MAX


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_jax(variant, route):
    got, want, differ = _results(variant)
    g, w = got["forward"], want[route]["forward"]
    assert g.shape == w.shape and g.shape[0] == B
    if not _tight(variant, route):
        assert np.abs(g - w).max() <= 5e-3 * np.abs(w).max()
    elif variant == "PPNG1":
        np.testing.assert_allclose(g[~differ], w[~differ], rtol=2.0**-7, atol=0)
    else:
        np.testing.assert_array_equal(g[~differ], w[~differ])


@pytest.mark.parametrize("part", ["params", "input", "eikonal"])
@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_gradients_match_jax(variant, route, part):
    got, want, _ = _results(variant)
    bound = GRAD_TIGHT if _tight(variant, route) else GRAD_XLA
    assert np.abs(want[route][part]).max() > 0
    assert _rel(got[part], want[route][part]) < bound
