"""What the training drivers share: the seeded weights handed to the
program, the readings of its first steps, and the reference's own first
steps on the same weights and batches."""

from __future__ import annotations

import contextlib

import torch

from .reference import field as ref

#: the steps the check follows; the window starts after them
CHECKED_STEPS = 3


def program_blocks(cfg: dict) -> dict:
    """The configuration's four blocks, as the program's config API takes them."""
    return {k: cfg[k] for k in ("loss", "optimizer", "encoding", "network")}


def seeded_weights(cfg: dict, seed: int, table_scale: float, n_params: int, device):
    """The seeded f32 weights of the reference's layout; raises when the
    program lays out another number of parameters."""
    f = ref.Field(cfg)
    if f.n_params != n_params:
        raise RuntimeError(f"the program holds {n_params} parameters, the reference {f.n_params}")
    return ref.initial_params(f, seed, table_scale, device)


class FirstSteps:
    """The program's readings over its first CHECKED_STEPS steps: each
    step's loss, the gradient the optimizer got in the first step (worked
    out from its state after it) and the parameters after the last."""

    def __init__(self, w0: torch.Tensor):
        self.w0 = w0
        self.losses = []
        self.grad = None
        self.after = None

    def record(self, step: int, loss, first_gradient, params) -> None:
        self.losses.append(loss.detach().float().reshape(()))
        if step == 0:
            self.grad = first_gradient().detach().float().clone()
        if step == CHECKED_STEPS - 1:
            self.after = params.detach().float().clone()

    def readings(self) -> dict:
        return {"losses": torch.stack(self.losses), "grad": self.grad,
                "change": self.after - self.w0}


def reference_steps(f: "ref.Field", w0: torch.Tensor, batches, loss_fn, optimizer,
                    gradient_scale: float = 1.0) -> dict:
    """The reference's readings of CHECKED_STEPS steps from `w0`:
    `loss_fn(f, params, batch)` per batch, its gradient times
    `gradient_scale` into `optimizer`."""
    w = w0.clone()
    losses = []
    with ref.strict_f32():
        for batch in batches[:CHECKED_STEPS]:
            p = w.detach().requires_grad_(True)
            loss = loss_fn(f, p, batch)
            (g,) = torch.autograd.grad(loss, p)
            losses.append(loss.detach())
            w = optimizer.step(w, g * gradient_scale)
            if len(losses) == 1:
                grad = optimizer.first_gradient().clone()
    return {"losses": torch.stack(losses), "grad": grad, "change": w - w0}


@contextlib.contextmanager
def optimizer_span(s):
    """The trainer's optimizer step inside the benchmark's span
    "pb.optimizer" (a driver's `spans`, traced runs only)."""
    opt = s.trainer.optimizer
    step = opt.step

    def traced(*args, **kwargs):
        with torch.profiler.record_function("pb.optimizer"):
            return step(*args, **kwargs)

    opt.step = traced
    try:
        yield
    finally:
        del opt.step
