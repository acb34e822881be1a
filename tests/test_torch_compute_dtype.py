"""The Trainer's compute_dtype (tcnn_tpu_torch/trainer.py) against tcnn_tpu's
on the CPU: at torch.float32 the loss scale is 1, the output f32, K6 and K3
are not chosen. On CPU tensors, which take the route tcnn_tpu takes off a
TPU, three Adam steps of a grid, a fixed-encoding, a Composite and the
three PPNG models match tcnn_tpu's Trainer at jnp.float32 from the same
params. Both compute the same f32 expressions: the grid's f32 gather and
interpolation (`_apply_xla`), the fixed encodings' f32 math, PPNG's f32
lookups and combines (K10's twin reading the f32 tables), and the MLP's
f32 matmul chain (`preferred_element_type=f32`). They sum in another order
(matmuls, the scatter of the table gradient); Adam divides each gradient
by its own root mean square, so a few ulps of a tiny gradient can move its
step. Bounds: losses rtol 1e-5, params norm-relative 1e-5, the inference
output after the steps norm-relative 1e-4 (measured: losses at most 8.7e-7
relative, params 3.3e-7, outputs 2.5e-7, but PPNG1's 1.3e-5: its product
of three lerps summed over ranks cancels, and carries the params' last
bits into the output). The card's route at f32, the kernels with their
outputs cast, is held against tcnn_tpu's TPU route at the end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu.trainer import Trainer as JaxTrainer

B = 256
GRID = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 10,
        "base_resolution": 4, "per_level_scale": 1.6}
#: (n_input_dims, encoding)
MODELS = {
    "grid": (2, GRID),
    "fixed": (3, {"otype": "Frequency", "n_frequencies": 4}),
    "composite": (3, {"otype": "Composite", "nested": [
        {**GRID, "n_dims_to_encode": 2}, {"otype": "OneBlob", "n_bins": 8}]}),
    "ppng3": (3, {"otype": "PPNG3", "n_quants": 8, "n_frequencies": 2, "n_features": 2}),
    "ppng1": (3, {"otype": "PPNG1", "n_quants": 8, "n_frequencies": 2, "n_features": 2,
                  "rank": 2}),
    "ppng2": (3, {"otype": "PPNG2", "n_quants": 8, "n_frequencies": 2, "n_features": 2,
                  "rank": 2}),
}
NETWORK = {"otype": "FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 1}
OPTIMIZER = {"otype": "Adam", "learning_rate": 1e-2}
LOSS = {"otype": "RelativeL2"}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _pair(name, compute_dtype=(jnp.float32, torch.float32)):
    d, enc = MODELS[name]
    jnet = tc.create_network_with_input_encoding(d, 3, enc, NETWORK)
    jt = JaxTrainer(jnet, tc.create_optimizer(OPTIMIZER), tc.create_loss(LOSS),
                    compute_dtype=compute_dtype[0])
    tnet = tt.create_network_with_input_encoding(d, 3, enc, NETWORK)
    tr = tt.Trainer(tnet, tt.create_optimizer(OPTIMIZER), tt.create_loss(LOSS), device="cpu",
                    compute_dtype=compute_dtype[1])
    p = np.asarray(jt.params).copy()
    n_net = jnet.network.n_params
    p[n_net:] = np.random.default_rng(0).uniform(-1, 1, p.size - n_net)
    jt.set_params(jnp.asarray(p))
    tr.set_params(tt.params_from_jax(p, tnet.n_params))
    return d, jt, tr


def _batch(d, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(B, d)).astype(np.float32)
    return x, np.stack([np.sin(5 * x[:, 0]), np.cos(3 * x[:, 1]), x[:, 0] * x[:, -1]],
                       -1).astype(np.float32) * 0.5 + 0.5


@pytest.mark.parametrize("name", list(MODELS))
def test_f32_trainer_matches_tcnn_tpu(name, monkeypatch):
    d, jt, tr = _pair(name)
    assert tr.loss_scale == jt.loss_scale == 1.0
    assert not tr.use_fused()
    monkeypatch.setattr(tt.trainer, "fused_forward_prepared",
                        lambda *a: pytest.fail("K3 chosen at f32"))
    for step in range(3):
        x, t = _batch(d, step)
        jl = float(jt.training_step(jnp.asarray(x), jnp.asarray(t)))
        tl = float(tr.training_step(torch.from_numpy(x), torch.from_numpy(t)))
        assert tl == pytest.approx(jl, rel=1e-5)
    assert _rel(tr.params.numpy(), jt.params) < 1e-5
    x, _ = _batch(d, 9)
    y = tr.inference(torch.from_numpy(x))
    want = np.asarray(jt.inference(jnp.asarray(x)))
    assert y.dtype == torch.float32
    assert _rel(y.numpy(), want) < 1e-4
    out = tr.model.apply(tr.params, torch.from_numpy(x), compute_dtype=torch.float32)
    assert out.dtype == torch.float32


@pytest.mark.parametrize("dtype,scale", [(torch.bfloat16, 128.0), (torch.float32, 1.0),
                                         (torch.float16, 128.0)])
def test_default_loss_scale(dtype, scale):
    from tcnn_tpu.common import default_loss_scale as jax_default

    jdtype = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
              torch.float16: jnp.float16}[dtype]
    assert tt.common.default_loss_scale(dtype) == jax_default(jdtype) == scale
    tnet = tt.create_network_with_input_encoding(2, 3, GRID, NETWORK)
    tr = tt.Trainer(tnet, tt.create_optimizer(OPTIMIZER), tt.create_loss(LOSS), device="cpu",
                    compute_dtype=dtype)
    assert tr.loss_scale == scale
    assert tt.Trainer(tnet, tt.create_optimizer(OPTIMIZER), tt.create_loss(LOSS), device="cpu",
                      compute_dtype=dtype, loss_scale=4.0).loss_scale == 4.0


def test_f32_input_gradients_match_tcnn_tpu():
    """The eikonal term at f32: the grid's plain route and the f32 chain,
    not K9 (whose operands are bf16), against tcnn_tpu at f32; rtol 1e-4
    norm-relative (measured 1.4e-7)."""
    d, jt, tr = _pair("grid")
    x = np.random.default_rng(3).uniform(size=(64, d)).astype(np.float32)
    p = np.asarray(jt.params)

    def jloss(pp):
        def f(xx):
            return jnp.sum(jt.model.apply(pp, xx, compute_dtype=jnp.float32,
                                          prepare_input_gradients=True)[:, 0])
        return jnp.mean((jnp.linalg.norm(jax.grad(f)(jnp.asarray(x)), axis=-1) - 1.0) ** 2)

    want = jax.jit(jax.grad(jloss))(jnp.asarray(p))
    pt = torch.from_numpy(p.copy()).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tr.model.apply(pt, xt, prepare_input_gradients=True, compute_dtype=torch.float32)
    assert out.dtype == torch.float32 and out.grad_fn.name() != "FusedApplyIgFnBackward"
    (g,) = torch.autograd.grad(out[:, 0].sum(), xt, create_graph=True)
    (got,) = torch.autograd.grad(((g.norm(dim=-1) - 1.0) ** 2).mean(), pt)
    assert _rel(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("name", ["grid", "fixed", "composite"])
def test_f32_card_route_matches_tcnn_tpus_tpu_route(name, monkeypatch):
    """The card's route at f32: the grid and FullyFusedMLP keep K1, K2, K5
    and K4, their bf16 outputs cast to f32, as tcnn_tpu's Trainer at
    jnp.float32 keeps its Pallas kernels on a TPU. Here it runs on the
    kernels' twins (`common.plain_route` patched to keep it on a CPU
    tensor) against tcnn_tpu's TPU route (`jax.default_backend` patched,
    Pallas in interpret mode): the output holds bf16 values, and the loss
    and the params gradient agree to 1e-5 relative (measured: at most
    6.1e-8 and 3.9e-9; both round each layer to bf16, from the same bf16
    operands). The f32 plain route reads 5.6e-3 to 7.6e-3 on the gradient
    against the same reference, so the bound tells the two routes apart."""
    from jax.experimental.pallas import tpu as pltpu

    d, jt, tr = _pair(name)
    monkeypatch.setattr(tt.common, "plain_route", lambda x, compute_dtype: False)
    x, t = _batch(d, 4)
    p = np.asarray(jt.params)
    out = tr.model.apply(torch.from_numpy(p.copy()), torch.from_numpy(x),
                         compute_dtype=torch.float32)
    assert out.dtype == torch.float32
    assert torch.equal(out, out.to(torch.bfloat16).float())
    tl, tg = tr.loss_and_grad_fn(tr.params, torch.from_numpy(x), torch.from_numpy(t))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        jl, jg = jt.loss_and_grad_fn(jnp.asarray(p), jnp.asarray(x), jnp.asarray(t), None,
                                     jax.random.PRNGKey(0))
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert _rel(tg.numpy(), jg) < 1e-5
