"""Driver: a supervised training loop through `Trainer.training_step(x, y)`,
closed loop, steps enqueued back to back with no synchronize between them.

Mix parameters: batch, ring (batches drawn in set-up and cycled, so the
window times the program and not the generator), image_size (the seeded
synthetic image the targets are fetched from), table_init (the table's
U(-a, a) bound), warmup (steps after the checked ones, before the window),
trace_units, trace_wait, probe_units; and, optionally, halves (each
batch's first half drawn at x < 0.5, its second at x >= 0.5,
`inputs.image_ring`).
"""

from __future__ import annotations

import types

from portbench import compare as cmp, inputs, training
from portbench.counts import field as counts
from portbench.reference import field as ref

UNIT = "step"
SYNC_EACH = False


def setup(cell, seed, device):
    import tcnn_tpu_torch as tt

    cfg, mix = cell.config, cell.mix
    model = tt.create_from_config(cfg["n_input_dims"], cfg["n_output_dims"],
                                  training.program_blocks(cfg), device=device)
    trainer = model.trainer
    w0 = training.seeded_weights(cfg, seed, mix["table_init"], model.network.n_params, device)
    trainer.set_params(w0)
    x, y = inputs.image_ring(seed, mix["batch"], mix["ring"], mix["image_size"], device,
                             mix.get("halves", False))
    s = types.SimpleNamespace(trainer=trainer, x=x, y=y, ring=mix["ring"], offset=0,
                              samples_per_unit=mix["batch"],
                              work=counts.train_step(cfg, mix["batch"]),
                              optimizer_s=counts.adam_seconds(model.network.n_params))
    first = training.FirstSteps(w0)
    opt_state = trainer.state["opt"]
    for i in range(training.CHECKED_STEPS):
        loss = trainer.training_step(x[i], y[i])
        first.record(i, loss, lambda: opt_state["first_moments"] / (1 - trainer.optimizer.beta1),
                     trainer.params)
    s.first = first
    for i in range(training.CHECKED_STEPS, training.CHECKED_STEPS + mix["warmup"]):
        trainer.training_step(x[i % s.ring], y[i % s.ring])
    s.offset = training.CHECKED_STEPS + mix["warmup"]
    return s


def unit(s, i):
    k = (s.offset + i) % s.ring
    s.trainer.training_step(s.x[k], s.y[k])


spans = training.optimizer_span


def readings(s):
    return s.first.readings()


def reference(cell, seed, device, precision):
    cfg, mix = cell.config, cell.mix
    f = ref.Field(cfg, precision)
    w0 = ref.initial_params(f, seed, mix["table_init"], device)
    x, y = inputs.image_ring(seed, mix["batch"], mix["ring"], mix["image_size"], device,
                             mix.get("halves", False))
    if cfg["loss"]["otype"] != "RelativeL2":
        raise ValueError("the reference holds the RelativeL2 loss here")
    opt = ref.TcnnAdam(cfg["optimizer"], f.n_params, f.mlp.n_params, device)
    return training.reference_steps(
        f, w0, list(zip(x, y)), lambda f, p, b: ref.relative_l2(f.forward(p, b[0]), b[1]), opt)


def compare(program, reference_, cell):
    return cmp.training(program, reference_, ref.Field(cell.config).leaves())
