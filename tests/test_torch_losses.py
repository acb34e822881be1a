"""The port's losses (tcnn_tpu_torch/ops/losses.py) against the reference's
golden vectors (tests/golden/golden.npz, as tests/test_golden.py:178-195)
and against the JAX package, on the CPU.

Tolerance: atol 1e-6 and rtol 1e-5, test_golden.py's own: both compute the
same f32 formulas in the same operation order, so only the last bit of a
division or a log may differ.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as tc
import tcnn_tpu_torch as tt

G = np.load(pathlib.Path(__file__).parent / "golden" / "golden.npz")

_LOSS_OTYPES = {
    "l2": "L2",
    "relative_l2": "RelativeL2",
    "relative_l2_luminance": "RelativeL2Luminance",
    "l1": "L1",
    "relative_l1": "RelativeL1",
    "mape": "MAPE",
    "smape": "SMAPE",
    "cross_entropy": "CrossEntropy",
    "variance_is": "Variance",
}


def _inputs(use_pdf):
    pred = torch.from_numpy(G["loss_pred"])  # [32, 8]: stride 8 > dims 3
    tgt = torch.from_numpy(G["loss_target"])  # [32, 3]
    pdf = torch.from_numpy(G["loss_pdf"]) if use_pdf else None
    return pred, tgt, pdf


@pytest.mark.parametrize("name", sorted(_LOSS_OTYPES))
@pytest.mark.parametrize("use_pdf", [0, 1])
def test_loss_matches_golden(name, use_pdf):
    loss = tt.create_loss({"otype": _LOSS_OTYPES[name]})
    pred, tgt, pdf = _inputs(use_pdf)
    values, grads = loss.value_and_grad_fn(pred, tgt, pdf)
    assert values.dtype == grads.dtype == torch.float32 and tuple(values.shape) == (32, 8)
    np.testing.assert_allclose(values.numpy(), G[f"loss_{name}_pdf{use_pdf}_values"],
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(grads.numpy(), G[f"loss_{name}_pdf{use_pdf}_grads"],
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(_LOSS_OTYPES))
def test_autograd_returns_the_specified_gradient(name):
    """Backward through `Loss.__call__` is the specified gradient times the
    upstream cotangent, rounded to the prediction's dtype as tcnn_tpu's
    custom vjp rounds it, and it matches jax.grad through tcnn_tpu's loss."""
    otype = _LOSS_OTYPES[name]
    loss = tt.create_loss({"otype": otype})
    pred, tgt, pdf = _inputs(1)
    p = pred.to(torch.bfloat16).requires_grad_(True)
    values = loss(p, tgt, pdf)
    (3.0 * values.sum()).backward()
    _, spec = loss.value_and_grad_fn(p.detach(), tgt, pdf)
    want = (3.0 * spec.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert p.grad.dtype == torch.bfloat16
    assert torch.equal(p.grad, want)
    import jax

    jl = tc.registry.create_loss({"otype": otype})
    jg = jax.grad(lambda q: 3.0 * jnp.sum(jl(q, jnp.asarray(tgt.numpy()), jnp.asarray(pdf.numpy()))))(
        jnp.asarray(p.detach().float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(np.asarray(jg.astype(jnp.float32)), p.grad.float().numpy())


def test_registry_defaults_and_unknown():
    assert tt.create_loss({}).otype == "RelativeL2"
    assert type(tt.create_loss({"OTYPE": "smape"})).__name__ == "SmapeLoss"
    with pytest.raises(ValueError, match="not found"):
        tt.create_loss({"otype": "Huber"})
    codes = [tt.create_loss({"otype": o}).kernel_code for o in _LOSS_OTYPES.values()]
    assert sorted(codes) == list(range(1, 10))
