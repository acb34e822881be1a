"""Fit a signed-distance field with a 3-D hash grid or a PPNG encoding +
MLP, trained with an eikonal term through second-order autodiff
(counterpart of ``samples/learn_a_sdf.py``, with its four configs).

    python -m tcnn_tpu_torch.samples.learn_a_sdf [encoding_otype] [n_steps] [device]

encoding_otype: HashGrid (default) | PPNG1 | PPNG2 | PPNG3. The model
supervises distances to an analytic shape (a sphere-box blend) and
regularises ||df/dx|| = 1 on the first points of each batch. With HashGrid
the eikonal term's first-order gradient runs the fused input-gradient route
(K3 forward, K9 backward) and its parameter gradient the composed route
again (K1, K7, K8); the data term runs K1, K2, K5 and K4. A PPNG model runs
the composed route for both terms: the encoding's gathers (K10, K11 for
PPNG1/2; K12, K13 for PPNG3) into the MLP's matmul chain for the eikonal
term and into K2/K5 for the data term. The device defaults to the card.
"""

from __future__ import annotations

import sys
import time

import torch

from ..config import create_from_config

ENCODING = {
    "otype": "HashGrid",
    "n_levels": 12,
    "n_features_per_level": 2,
    "log2_hashmap_size": 17,
    "base_resolution": 8,
    "per_level_scale": 1.5,
}
#: The encodings of samples/learn_a_sdf.py:26-44.
ENCODINGS = {
    "HashGrid": ENCODING,
    "PPNG1": {"otype": "PPNG1", "n_quants": 64, "n_frequencies": 6, "n_features": 4, "rank": 4},
    "PPNG2": {"otype": "PPNG2", "n_quants": 32, "n_frequencies": 4, "n_features": 2, "rank": 2},
    "PPNG3": {"otype": "PPNG3", "n_quants": 32, "n_frequencies": 4, "n_features": 2},
}


def config(otype: str = "HashGrid") -> dict:
    """The sample's model config with the encoding `otype`."""
    return {
        "loss": {"otype": "L2"},
        "optimizer": {"otype": "Adam", "learning_rate": 3e-3},
        "encoding": dict(ENCODINGS[otype]),
        "network": {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2},
    }


CONFIG = config()
BATCH = 1 << 16
N_EIKONAL = 1024
EIKONAL_WEIGHT = 0.01


def sdf_true(p: torch.Tensor) -> torch.Tensor:
    """Blend of a sphere and a rounded box, centred in [0, 1]^3: [B, 3] ->
    [B]."""
    q = p - 0.5
    sphere = torch.linalg.vector_norm(q, dim=-1) - 0.3
    box = torch.linalg.vector_norm(torch.clamp_min(q.abs() - 0.22, 0.0), dim=-1) - 0.05
    return torch.minimum(sphere, box)


def eikonal_grad(model, params, xe: torch.Tensor, fused_ig: bool = True) -> torch.Tensor:
    """df/dx [B, 3] f32 of the first output at the points `xe`, kept
    differentiable with respect to `params` (create_graph): one batched
    gradient of the sum, since outputs are independent per sample."""
    xe = xe.detach().requires_grad_(True)
    out = model.apply(params, xe, prepare_input_gradients=True, _no_fused_ig=not fused_ig)
    (g,) = torch.autograd.grad(out[:, 0].float().sum(), xe, create_graph=True)
    return g


def data_term(model, params, xs: torch.Tensor) -> torch.Tensor:
    """mean((f(x) - sdf(x))^2) over the points `xs`."""
    out = model.apply(params, xs)[:, :1].float()
    return torch.mean((out - sdf_true(xs)[:, None]) ** 2)


def sdf_loss(model, params, xs: torch.Tensor, n_eikonal: int = N_EIKONAL,
             eikonal_weight: float = EIKONAL_WEIGHT, fused_ig: bool = True) -> torch.Tensor:
    """data_term + eikonal_weight * mean((||df/dx|| - 1)^2), the eikonal
    term on the first `n_eikonal` points (samples/learn_a_sdf.py:72-94)."""
    data = data_term(model, params, xs)
    g = eikonal_grad(model, params, xs[:n_eikonal], fused_ig)
    eik = torch.mean((torch.linalg.vector_norm(g, dim=-1) - 1.0) ** 2)
    return data + eikonal_weight * eik


def loss_and_grad(trainer, xs: torch.Tensor, fused_ig: bool = True):
    """(loss, f32 gradient of the flat params) of `sdf_loss` at the
    trainer's params."""
    p = trainer.params.detach().requires_grad_(True)
    loss = sdf_loss(trainer.model, p, xs, fused_ig=fused_ig)
    (grads,) = torch.autograd.grad(loss, p)
    return loss.detach(), grads


def train_step(trainer, xs: torch.Tensor) -> torch.Tensor:
    """One Adam step on `sdf_loss`, as the JAX sample takes it
    (samples/learn_a_sdf.py:96-102): loss_scale 1 into the optimizer and
    the gradient times the trainer's loss_scale. Returns the loss."""
    loss, grads = loss_and_grad(trainer, xs)
    trainer.optimizer.step(trainer.state["opt"], 1.0, trainer.params, grads * trainer.loss_scale)
    return loss


@torch.no_grad()
def slice_error(model, params, n: int = 128) -> float:
    """Mean |f - sdf| over an n x n grid of the z = 0.5 slice
    (samples/learn_a_sdf.py:118-125)."""
    u = (torch.arange(n, dtype=torch.float32, device=params.device) + 0.5) / n
    yy, xx = torch.meshgrid(u, u, indexing="ij")
    pts = torch.stack([xx.reshape(-1), yy.reshape(-1), torch.full((n * n,), 0.5, device=params.device)], -1)
    pred = model.apply(params, pts)[:, 0].float()
    return float(torch.mean(torch.abs(pred - sdf_true(pts))))


def main(argv) -> int:
    args = list(argv[1:])
    otype = args.pop(0) if args and args[0] in ENCODINGS else "HashGrid"
    n_steps = int(args[0]) if args else 2000
    device = args[1] if len(args) > 1 else "cuda"
    model = create_from_config(3, 1, config(otype), device=device)
    trainer = model.trainer
    print(f"SDF with {otype}: {model.network.n_params} params on {trainer.device}")
    gen = torch.Generator(device=trainer.device).manual_seed(1337)
    held_out = torch.rand(BATCH, 3, generator=torch.Generator(device=trainer.device).manual_seed(7),
                          device=trainer.device)
    with torch.no_grad():
        data_before = float(data_term(model.network, trainer.params, held_out))
    t0 = time.time()
    interval = 10
    for step in range(1, n_steps + 1):
        xs = torch.rand(BATCH, 3, generator=gen, device=trainer.device)
        loss = train_step(trainer, xs)
        if step == 1 or step % interval == 0 or step == n_steps:
            print(f"step {step}: loss {float(loss):.6e} ({step / (time.time() - t0):.1f} steps/s)")
            if step // interval == 10:
                interval *= 10
    with torch.no_grad():
        data_after = float(data_term(model.network, trainer.params, held_out))
    print(f"data term on {BATCH} held-out points: {data_before:.6e} -> {data_after:.6e}")
    print(f"mean |SDF error| on z=0.5 slice: {slice_error(model.network, trainer.params):.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
