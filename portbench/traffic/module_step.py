"""Driver: the PyTorch binding user's training loop, after tiny-cuda-nn's
samples/mlp_learning_an_image_pytorch.py: `NetworkWithInputEncoding`
forward, the sample's relative L2 loss, `backward()` and an external
`torch.optim.Adam`, closed loop, steps enqueued back to back.

The configuration's "encoding" and "network" blocks build the module; the
loop's optimizer is the mix's (`adam`: lr, betas, eps). The module's
parameter is overwritten with the benchmark's seeded weights.

Mix parameters: batch, ring, image_size, table_init, adam, warmup,
trace_units, trace_wait, probe_units.
"""

from __future__ import annotations

import contextlib
import types

import torch

from portbench import compare as cmp, inputs, training
from portbench.counts import field as counts
from portbench.reference import field as ref

UNIT = "step"
SYNC_EACH = False


def relative_l2(y, targets):
    """The sample's loss: mean((y - t)^2 / (sg(y)^2 + 0.01))."""
    return torch.mean((y - targets) ** 2 / (y.detach() ** 2 + 0.01))


def _step(s, x, y):
    with s.span("pb.forward"):
        loss = relative_l2(s.module(x), y)
    with s.span("pb.backward"):
        loss.backward()
    with s.span("pb.optimizer"):
        s.opt.step()
        s.opt.zero_grad(set_to_none=True)
    return loss


def _no_span(name):
    return contextlib.nullcontext()


def setup(cell, seed, device):
    import tcnn_tpu_torch as tt

    cfg, mix = cell.config, cell.mix
    module = tt.NetworkWithInputEncoding(cfg["n_input_dims"], cfg["n_output_dims"],
                                         cfg["encoding"], cfg["network"], device=device)
    w0 = training.seeded_weights(cfg, seed, mix["table_init"], module.n_params, device)
    with torch.no_grad():
        module.params.copy_(w0)
    a = mix["adam"]
    opt = torch.optim.Adam(module.parameters(), lr=a["lr"], betas=tuple(a["betas"]), eps=a["eps"])
    x, y = inputs.image_ring(seed, mix["batch"], mix["ring"], mix["image_size"], device)
    s = types.SimpleNamespace(module=module, opt=opt, x=x, y=y, ring=mix["ring"], span=_no_span,
                              samples_per_unit=mix["batch"],
                              work=counts.train_step(cfg, mix["batch"]), optimizer_s=None)
    first = training.FirstSteps(w0)
    for i in range(training.CHECKED_STEPS):
        loss = _step(s, x[i], y[i])
        first.record(i, loss, lambda: opt.state[module.params]["exp_avg"] / (1 - a["betas"][0]),
                     module.params)
    s.first = first
    for i in range(training.CHECKED_STEPS, training.CHECKED_STEPS + mix["warmup"]):
        _step(s, x[i % s.ring], y[i % s.ring])
    s.offset = training.CHECKED_STEPS + mix["warmup"]
    return s


def unit(s, i):
    k = (s.offset + i) % s.ring
    _step(s, s.x[k], s.y[k])


@contextlib.contextmanager
def spans(s):
    s.span = torch.profiler.record_function
    try:
        yield
    finally:
        s.span = _no_span


def readings(s):
    return s.first.readings()


def reference(cell, seed, device, precision):
    cfg, mix = cell.config, cell.mix
    f = ref.Field(cfg, precision)
    w0 = ref.initial_params(f, seed, mix["table_init"], device)
    x, y = inputs.image_ring(seed, mix["batch"], mix["ring"], mix["image_size"], device)
    a = mix["adam"]
    opt = ref.TorchAdam(a["lr"], tuple(a["betas"]), a["eps"], f.n_params, device)
    return training.reference_steps(
        f, w0, list(zip(x, y)), lambda f, p, b: ref.relative_l2_mean(f.forward(p, b[0]), b[1]), opt)


def compare(program, reference_, cell):
    return cmp.training(program, reference_, ref.Field(cell.config).leaves())
