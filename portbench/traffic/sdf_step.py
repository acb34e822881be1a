"""Driver: the eikonal SDF loop of `tcnn_tpu_torch.samples.learn_a_sdf`,
`train_step(trainer, xs)`, closed loop, steps enqueued back to back.

The configuration's "eikonal" block states the sample's loss: the eikonal
penalty on the first `n_points` points of each batch with `weight`, and
the gradient handed to the optimizer times `optimizer_gradient_scale`
with a loss scale of 1. The driver refuses a program whose sample states
another.

Mix parameters: batch, ring, table_init, warmup, trace_units, trace_wait,
probe_units.
"""

from __future__ import annotations

import types

from portbench import compare as cmp, inputs, training
from portbench.counts import field as counts
from portbench.reference import field as ref

UNIT = "step"
SYNC_EACH = False
spans = training.optimizer_span


def _sample(cfg):
    from tcnn_tpu_torch.samples import learn_a_sdf

    eik = cfg["eikonal"]
    if (learn_a_sdf.N_EIKONAL, learn_a_sdf.EIKONAL_WEIGHT) != (eik["n_points"], eik["weight"]):
        raise RuntimeError("the program's SDF sample states another eikonal term than the configuration")
    return learn_a_sdf


def setup(cell, seed, device):
    import tcnn_tpu_torch as tt

    cfg, mix = cell.config, cell.mix
    sample = _sample(cfg)
    model = tt.create_from_config(cfg["n_input_dims"], cfg["n_output_dims"],
                                  training.program_blocks(cfg), device=device)
    trainer = model.trainer
    if trainer.loss_scale != cfg["eikonal"]["optimizer_gradient_scale"]:
        raise RuntimeError(f"the trainer's loss scale is {trainer.loss_scale}")
    w0 = training.seeded_weights(cfg, seed, mix["table_init"], model.network.n_params, device)
    trainer.set_params(w0)
    xs = inputs.point_ring(seed, mix["batch"], mix["ring"], cfg["n_input_dims"], device)
    s = types.SimpleNamespace(trainer=trainer, xs=xs, ring=mix["ring"], step=sample.train_step,
                              samples_per_unit=mix["batch"],
                              work=counts.eikonal_step(cfg, mix["batch"], cfg["eikonal"]["n_points"]),
                              optimizer_s=counts.adam_seconds(model.network.n_params))
    first = training.FirstSteps(w0)
    opt_state = trainer.state["opt"]
    for i in range(training.CHECKED_STEPS):
        loss = s.step(trainer, xs[i])
        first.record(i, loss, lambda: opt_state["first_moments"] / (1 - trainer.optimizer.beta1),
                     trainer.params)
    s.first = first
    for i in range(training.CHECKED_STEPS, training.CHECKED_STEPS + mix["warmup"]):
        s.step(trainer, xs[i % s.ring])
    s.offset = training.CHECKED_STEPS + mix["warmup"]
    return s


def unit(s, i):
    s.step(s.trainer, s.xs[(s.offset + i) % s.ring])


def readings(s):
    return s.first.readings()


def reference(cell, seed, device, precision):
    cfg, mix = cell.config, cell.mix
    eik = cfg["eikonal"]
    f = ref.Field(cfg, precision)
    w0 = ref.initial_params(f, seed, mix["table_init"], device)
    xs = inputs.point_ring(seed, mix["batch"], mix["ring"], cfg["n_input_dims"], device)
    opt = ref.TcnnAdam(cfg["optimizer"], f.n_params, f.mlp.n_params, device)
    return training.reference_steps(
        f, w0, list(xs), lambda f, p, b: ref.sdf_loss(f, p, b, eik["n_points"], eik["weight"]),
        opt, gradient_scale=eik["optimizer_gradient_scale"])


def compare(program, reference_, cell):
    return cmp.training(program, reference_, ref.Field(cell.config).leaves())
