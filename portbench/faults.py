"""Faults planted in the program's timed path, to show that the check
catches them (`tests/test_portbench_faults.py` on the CPU, `calibrate.py`
on the card at the cell's own size):

  unchanged  a training step that leaves the parameters as they were
  half       half of the batch left out, the mean taken over the rest
  altered    one answer altered where it is produced

Each is a context manager that patches the program while it is open.
"""

from __future__ import annotations

import contextlib

import torch

KINDS = {"trainer_step": ("unchanged", "half"), "sdf_step": ("unchanged", "half"),
         "module_step": ("unchanged", "half"), "render_frames": ("half", "altered")}


@contextlib.contextmanager
def _patched(owner, name, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _no_step(original):
    def step(self, state, loss_scale, weights, grads, lr_scale=1.0):
        return None
    return step


def plant(driver: str, kind: str):
    if kind not in KINDS[driver]:
        raise ValueError(f"{driver} has no fault {kind!r}")
    from tcnn_tpu_torch import modules, trainer
    from tcnn_tpu_torch.optimizers.adam import AdamOptimizer
    from tcnn_tpu_torch.samples import learn_a_sdf

    if kind == "unchanged" and driver in ("trainer_step", "sdf_step"):
        return _patched(AdamOptimizer, "step", _no_step)
    if kind == "unchanged":  # the module's output carries no gradient
        return _patched(modules.Module, "forward",
                        lambda f: lambda self, x, params=None: (lambda y: y.detach() + 0.0 * y)(f(self, x, params)))
    if kind == "half" and driver == "trainer_step":
        def step(f):
            def half(self, inputs, targets=None, pdf=None, dL_doutput=None):
                n = inputs.shape[0] // 2
                return f(self, inputs[:n], targets[:n])
            return half
        return _patched(trainer.Trainer, "training_step", step)
    if kind == "half" and driver == "sdf_step":
        return _patched(learn_a_sdf, "train_step",
                        lambda f: lambda tr, xs: f(tr, xs[: xs.shape[0] // 2]))
    if kind == "half" and driver == "module_step":
        def forward(f):
            def half(self, x, params=None):
                y = f(self, x, params)
                n = y.shape[0] // 2
                a, b = y[:n], y[n:]
                return torch.cat([a + (a - a.detach()), b.detach()])
            return half
        return _patched(modules.Module, "forward", forward)
    if kind == "half":  # render_frames: the second half of each chunk unanswered
        def infer(f):
            def half(self, inputs):
                n = inputs.shape[0] // 2
                y = f(self, inputs[:n])
                return torch.cat([y, torch.zeros((inputs.shape[0] - n, y.shape[1]), device=y.device)])
            return half
        return _patched(trainer.Trainer, "inference", infer)

    def infer(f):  # altered
        def altered(self, inputs):
            y = f(self, inputs).clone()
            y[0, 0] += 1.0
            return y
        return altered
    return _patched(trainer.Trainer, "inference", infer)
