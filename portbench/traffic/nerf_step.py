"""Driver: a NeRF training loop through `Trainer.training_step(x, rays)`,
closed loop, steps enqueued back to back with no synchronize between them.

Each batch holds `batch` samples of rays packed in order: ray lengths
i.i.d. geometric of mean `mean_samples`, clipped to [1, steps], the last
ray cut at the batch's end. A ray starts at a point uniform in [0, 1]^3
and runs along a direction uniform on the sphere; its k-th sample sits at
t = (k + 1/2) dt, dt = sqrt(3) / steps (instant-ngp's step at aabb_scale
1), clamped to the cube; the direction is stored as (d + 1) / 2. Each ray
has a background and a target colour, uniform in [0, 1]^3. Every batch
draws from its own generator, seeded from the run's seed and its index.

Mix parameters: batch, ring (batches drawn in set-up and cycled),
mean_samples, steps, table_init, warmup, trace_units, trace_wait,
probe_units.

FAULTS, each a context manager that plants a fault in the program while
it is open:
  unchanged  the optimizer's Adam step leaves the parameters as they were
  half       the second half of each batch's rays left out
  opaque     the compositing ignores transmittance (T = 1 everywhere)
  no_ema     the EMA wrapper runs its nested step and keeps no average
"""

from __future__ import annotations

import contextlib
import math
import types

import torch

from portbench import compare as cmp, training
from portbench.counts import nerf as counts
from portbench.reference import nerf as ref

UNIT = "step"
SYNC_EACH = False
BLOCKS = ("loss", "optimizer", "encoding", "network", "dir_encoding", "rgb_network")
spans = training.optimizer_span


def _generator(seed: int, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 4099 + 17 * (index + 1)) % (1 << 63))


def ray_batch(seed: int, index: int, mix: dict, device):
    """(x f32 [B, 6], offsets int64 [R + 1], dt f32 [B], background f32
    [R, 3], target f32 [R, 3]) of batch `index`."""
    gen = _generator(seed, index, device)
    batch, mean, steps = int(mix["batch"]), float(mix["mean_samples"]), int(mix["steps"])
    n = 2 * batch // int(mean) + 64
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    lengths = (torch.floor(torch.log1p(-u) / math.log1p(-1.0 / mean)) + 1).clamp(1, steps).long()
    ends = torch.cumsum(lengths, 0)
    n_rays = int((ends < batch).sum()) + 1
    if n_rays > n:
        raise RuntimeError("the drawn rays do not fill the batch")
    lengths = lengths[:n_rays]
    lengths[-1] -= int(ends[n_rays - 1]) - batch
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=device), torch.cumsum(lengths, 0)])
    r = torch.rand(n_rays, 9, generator=gen, device=device)
    d = torch.randn(n_rays, 3, generator=gen, device=device)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    ray = torch.repeat_interleave(torch.arange(n_rays, device=device), lengths)
    dt = math.sqrt(3.0) / steps
    t = (torch.arange(batch, device=device) - offsets[:-1][ray]).float().add_(0.5).mul_(dt)
    pos = (r[ray, :3] + t[:, None] * d[ray]).clamp_(0.0, 1.0)
    x = torch.cat([pos, (d[ray] + 1.0) * 0.5], 1).contiguous()
    return (x, offsets, torch.full((batch,), dt, device=device),
            r[:, 3:6].contiguous(), r[:, 6:9].contiguous())


def setup(cell, seed, device):
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.ops.volume import Rays

    cfg, mix = cell.config, cell.mix
    model = tt.create_from_config(cfg["n_input_dims"], cfg["n_output_dims"],
                                  {k: cfg[k] for k in BLOCKS}, device=device)
    trainer = model.trainer
    nerf = ref.Nerf(cfg)
    if nerf.n_params != model.network.n_params:
        raise RuntimeError(f"the program holds {model.network.n_params} parameters, "
                           f"the reference {nerf.n_params}")
    w0 = ref.initial_params(nerf, seed, mix["table_init"], device)
    trainer.set_params(w0)
    batches = [ray_batch(seed, i, mix, device) for i in range(mix["ring"])]
    xs = [b[0] for b in batches]
    rays = [Rays(*b[1:]) for b in batches]
    n_rays = sum(r.n_rays for r in rays) / len(rays)
    s = types.SimpleNamespace(trainer=trainer, x=xs, rays=rays, ring=mix["ring"], offset=0,
                              samples_per_unit=mix["batch"],
                              work=counts.train_step(cfg, mix["batch"], n_rays),
                              optimizer_s=counts.chain_seconds(nerf.n_params))
    adam = trainer.optimizer.nested.nested
    adam_state = trainer.state["opt"]["nested"]["nested"]
    first = training.FirstSteps(w0)
    for i in range(training.CHECKED_STEPS):
        loss = trainer.training_step(xs[i], rays[i])
        first.record(i, loss, lambda: adam_state["first_moments"] / (1 - adam.beta1), trainer.params)
    s.first = first
    s.ema = trainer.state["opt"]["ema"].detach().clone()
    for i in range(training.CHECKED_STEPS, training.CHECKED_STEPS + mix["warmup"]):
        trainer.training_step(xs[i % s.ring], rays[i % s.ring])
    s.offset = training.CHECKED_STEPS + mix["warmup"]
    return s


def unit(s, i):
    k = (s.offset + i) % s.ring
    s.trainer.training_step(s.x[k], s.rays[k])


def readings(s):
    return {**s.first.readings(), "ema": s.ema}


def reference(cell, seed, device, precision):
    cfg, mix = cell.config, cell.mix
    nerf = ref.Nerf(cfg, precision)
    w0 = ref.initial_params(nerf, seed, mix["table_init"], device)
    batches = [ray_batch(seed, i, mix, device) for i in range(training.CHECKED_STEPS)]
    chain = ref.Chain(cfg["optimizer"], nerf.n_params, nerf.n_matrix, device)
    out = training.reference_steps(nerf, w0, batches, ref.loss, chain)
    return {**out, "ema": chain.average}


def median_leaf_gap(program: torch.Tensor, reference_: torch.Tensor, leaves) -> float:
    """The median over the leaves of each leaf's gap as `worst_leaf_gap`
    takes it: | |p| - |r| | over max(|r|, the median leaf's |r|)."""
    p, r = cmp._leaf_norms(program, leaves), cmp._leaf_norms(reference_, leaves)
    med = cmp._median(r)
    return cmp._median([abs(a - b) / max(b, med) for a, b in zip(p, r)])


def compare(program, reference_, cell):
    """`compare.training`'s numbers; `grad_mid_gap`, the first gradient's
    gap by the median leaf, which a rounding coarser than the program's
    moves in most leaves where the worst leaf swings from seed to seed;
    `ema_gap`, EMA's average after the checked steps by the worst leaf."""
    leaves = ref.Nerf(cell.config).leaves()
    numbers = cmp.training(program, reference_, leaves)
    numbers["grad_mid_gap"] = median_leaf_gap(program["grad"], reference_["grad"], leaves)
    numbers["ema_gap"], numbers["_leaves"]["ema"] = cmp.worst_leaf_gap(
        program["ema"], reference_["ema"], leaves)
    return numbers


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _patched(owner, name, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _unchanged():
    from tcnn_tpu_torch.optimizers.adam import AdamOptimizer

    return _patched(AdamOptimizer, "step", lambda f: lambda self, *a, **k: None)


def _half():
    from tcnn_tpu_torch import trainer
    from tcnn_tpu_torch.ops.volume import Rays

    def step(f):
        def half(self, inputs, targets=None, pdf=None, dL_doutput=None):
            r = targets.n_rays // 2
            n = int(targets.offsets[r])
            rays = Rays(targets.offsets[: r + 1], targets.dt[:n], targets.background[:r],
                        targets.rgb[:r])
            return f(self, inputs[:n], rays)
        return half
    return _patched(trainer.Trainer, "training_step", step)


def _opaque():
    from tcnn_tpu_torch.ops import volume

    def transmittance(f):
        def ones(*args):
            t, t_end = f(*args)
            return torch.ones_like(t), torch.ones_like(t_end)
        return ones
    return _patched(volume, "transmittance", transmittance)


def _no_ema():
    from tcnn_tpu_torch.optimizers.wrappers import EmaOptimizer

    def step(f):
        def nested_only(self, state, loss_scale, weights, grads, lr_scale=1.0):
            self.nested.step(state["nested"], loss_scale, weights, grads, lr_scale)
        return nested_only
    return _patched(EmaOptimizer, "step", step)


FAULTS = {"unchanged": _unchanged, "half": _half, "opaque": _opaque, "no_ema": _no_ema}
