"""Driver: a viewer querying a field frame by frame through
`Trainer.inference`, in chunks of `chunk` queries, each frame ended by a
synchronize (closed loop: the next frame waits for this one).

The frames cycle through `views` seeded views of the unit square, each a
random zoom (`zoom`) and pan of a `height` x `width` pixel-centre lattice,
made in set-up. The weights are seeded, the table drawn from U(-a, a) with
a = table_init, so that the field's answers are of order one, as a
trained field's are.

Each view's last frame in the window is kept and compared, row by row,
with the plain reference once the window has closed.

Mix parameters: views, height, width, zoom, chunk, table_init, warmup,
trace_units, trace_wait, probe_units.
"""

from __future__ import annotations

import contextlib
import types

import torch

from portbench import compare as cmp, inputs, training
from portbench.counts import field as counts
from portbench.reference import field as ref

UNIT = "frame"
SYNC_EACH = True


def _views(cell, seed, device):
    mix = cell.mix
    return inputs.views(seed, mix["views"], mix["height"], mix["width"], tuple(mix["zoom"]), device)


def _frame(s, v):
    q = s.views[v]
    return [s.trainer.inference(q[j : j + s.chunk]) for j in range(0, q.shape[0], s.chunk)]


def setup(cell, seed, device):
    import tcnn_tpu_torch as tt

    cfg, mix = cell.config, cell.mix
    model = tt.create_from_config(cfg["n_input_dims"], cfg["n_output_dims"],
                                  training.program_blocks(cfg), device=device)
    trainer = model.trainer
    w0 = training.seeded_weights(cfg, seed, mix["table_init"], model.network.n_params, device)
    trainer.set_params(w0)
    views = _views(cell, seed, device)
    queries = views.shape[1]
    s = types.SimpleNamespace(trainer=trainer, views=views, chunk=mix["chunk"], kept={},
                              samples_per_unit=queries, work=counts.inference(cfg, queries),
                              optimizer_s=None)
    for i in range(mix["warmup"]):
        _frame(s, i % views.shape[0])
    return s


def unit(s, i):
    v = i % s.views.shape[0]
    s.kept[v] = _frame(s, v)


def spans(s):
    return contextlib.nullcontext()


def readings(s):
    return {"outputs": {v: torch.cat(out) for v, out in s.kept.items()}}


def reference(cell, seed, device, precision):
    f = ref.Field(cell.config, precision)
    w0 = ref.initial_params(f, seed, cell.mix["table_init"], device)
    views = _views(cell, seed, device)
    with ref.strict_f32():
        return {"outputs": {v: f.forward_blocks(w0, views[v]) for v in range(views.shape[0])}}


def compare(program, reference_, cell):
    return cmp.answers(program, reference_)
