"""Data parallelism on `torch.distributed` (counterpart of
``tcnn_tpu/parallel/data_parallel.py``).

The reference is strictly single-GPU. Here the sample batch, the
reference's only long axis, is sharded across the ranks of a 1-D mesh, the
parameters are replicated, and each rank's flat parameter gradient is
all-reduced between the gradient and the optimizer step: the gradient comes
from `Trainer.loss_and_grad_fn` on the rank's shard (the fused train kernel
K6 on the fused route; K1 K2 K5 K4 on the composed one), so the reduction
sits after K6 and before the optimizer, never inside a kernel. The
optimizer then runs replicated, identically on every rank, so the ranks'
params stay bit-equal. One process per rank (`distributed.init_distributed`).

Usage, on every rank:
    mesh = create_mesh()                     # all ranks
    dp = DataParallelTrainer(trainer, mesh)
    state = dp.replicate(trainer.state)
    state, loss = dp.step(state, x, y)       # x, y: the global batch
"""

from __future__ import annotations

import os
import tempfile
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.serialization import tree_leaves
from .distributed import fold_in, global_mesh, init_distributed, mesh_device_type


def create_mesh(devices=None, axis_name: str = "data") -> DeviceMesh:
    """1-D mesh over all ranks, or over the ranks `devices`."""
    if devices is None:
        return global_mesh(axis_name)
    return DeviceMesh(mesh_device_type(), list(devices), mesh_dim_names=(axis_name,))


class DataParallelTrainer:
    """Wraps a Trainer's step with batch sharding and a gradient all-reduce.

    Each rank's perturbation noise draws from the trainer's seed with the
    rank folded in, as tcnn_tpu folds the mesh axis index into its key; the
    stochastic interpolation's draws depend on a sample's index in the
    rank's shard, as on each tcnn_tpu shard."""

    def __init__(self, trainer, mesh: DeviceMesh):
        self.trainer = trainer
        self.mesh = mesh
        self.group = mesh.get_group()
        self.n = mesh.size()
        self.rank = mesh.get_local_rank()
        gen = trainer.noise_generator
        gen.manual_seed(fold_in(gen.initial_seed(), self.rank))

    def replicate(self, state):
        """Broadcast every tensor of `state` (params and the nested
        optimizer state) from the mesh's first rank, in place; returns it."""
        src = dist.get_global_rank(self.group, 0)
        for leaf in tree_leaves(state):
            dist.broadcast(leaf, src=src, group=self.group)
        self.trainer.optimizer.load_state(state["opt"])  # its host-side step counts
        return state

    def shard_batch(self, *arrays):
        """This rank's contiguous block of rows [r B / n, (r + 1) B / n) of
        each array, on the trainer's device."""
        out = []
        for a in arrays:
            a = torch.as_tensor(a)
            b = a.shape[0]
            if b % self.n:
                raise ValueError(f"batch {b} is not a multiple of the mesh's {self.n} ranks")
            rows = b // self.n
            out.append(a[self.rank * rows:(self.rank + 1) * rows].to(self.trainer.device))
        return tuple(out)

    def _all_reduce(self, t: torch.Tensor, mean: bool) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t.div_(self.n) if mean else t

    def loss_and_grad(self, params, inputs, targets, pdf=None):
        """(loss, flat gradient), each the mean over the ranks of the
        rank's shard's: the per-shard loss normalises by the local batch,
        and the mean restores the global batch's 1/n_total."""
        tr = self.trainer
        data = self.shard_batch(inputs, targets, *(() if pdf is None else (pdf,)))
        x, t, *p = (tr._input(d) for d in data)
        loss, grads = tr.loss_and_grad_fn(params, x, t, p[0] if p else None)
        return (self._all_reduce(loss.detach().float().reshape(1), mean=True).reshape(()),
                self._all_reduce(grads, mean=True))

    def step(self, state, inputs, targets, pdf=None):
        """One step on the global batch: `state` updated in place; returns
        (state, loss)."""
        loss, grads = self.loss_and_grad(state["params"], inputs, targets, pdf)
        self.trainer.optimizer.step(state["opt"], self.trainer.loss_scale, state["params"], grads)
        return state, loss

    def external_grad(self, params, inputs, dL_doutput):
        """The flat gradient from a caller's dL/doutput, summed over the
        ranks: external gradients are per-sample sums whose normalisation
        the caller owns."""
        tr = self.trainer
        x, dl = (tr._input(d) for d in self.shard_batch(inputs, dL_doutput))
        return self._all_reduce(tr.external_grad_fn(params, x, dl), mean=False)

    def step_external(self, state, inputs, dL_doutput):
        """One step from a caller's dL/doutput (trainer.h:127-131) on the
        global batch: `state` updated in place and returned."""
        grads = self.external_grad(state["params"], inputs, dL_doutput)
        self.trainer.optimizer.step(state["opt"], self.trainer.loss_scale, state["params"], grads)
        return state


# ---------------------------------------------------------------------------
# dry run: a few data-parallel steps on spawned ranks
# ---------------------------------------------------------------------------

#: The dry run's models: config_hash (data/config_hash.json) under EMA of
#: Adam, and PPNG3 at its factory defaults, each DRYRUN_STEPS steps on a
#: global batch of DRYRUN_BATCH.
DRYRUN_ADAM = {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99,
               "epsilon": 1e-15, "l2_reg": 1e-6}
DRYRUN_CONFIGS = {
    "config_hash EMA(Adam)": (2, {
        "loss": {"otype": "RelativeL2"},
        "optimizer": {"otype": "EMA", "decay": 0.99, "nested": DRYRUN_ADAM},
        "encoding": {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2,
                     "log2_hashmap_size": 15, "base_resolution": 16, "per_level_scale": 1.5},
        "network": {"otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "None",
                    "n_neurons": 64, "n_hidden_layers": 2}}),
    "PPNG3": (3, {
        "loss": {"otype": "RelativeL2"},
        "optimizer": DRYRUN_ADAM,
        "encoding": {"otype": "PPNG3"},
        "network": {"otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "None",
                    "n_neurons": 64, "n_hidden_layers": 2}}),
}
DRYRUN_STEPS = 5
DRYRUN_BATCH = 1 << 14


def _dryrun_target(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.sin(4 * x[:, 0]) * 0.5 + 0.5, torch.cos(3 * x[:, 1]) * 0.5 + 0.5,
                        x[:, 0] * x[:, 1]], -1)


def _dryrun_rank(rank, n_ranks, address, device, backend, results) -> None:
    """One rank of `dryrun_multichip`: each DRYRUN_CONFIGS model
    DRYRUN_STEPS data-parallel steps; puts (rank, {config: losses,
    "launches": kernel launches}) or (rank, the error) on `results`."""
    try:
        from ..config import create_from_config
        from ..ops.cuda import _build

        init_distributed(address, n_ranks, rank,
                         local_device_ids=[rank % max(torch.cuda.device_count(), 1)],
                         backend=backend)
        mesh = create_mesh()
        out = {}
        gen = torch.Generator(device=device).manual_seed(1337)  # the same global batch everywhere
        for name, (n_in, cfg) in DRYRUN_CONFIGS.items():
            model = create_from_config(n_in, 3, cfg, device=device)
            dp = DataParallelTrainer(model.trainer, mesh)
            state = dp.replicate(model.trainer.state)
            x = torch.rand(DRYRUN_BATCH, n_in, generator=gen, device=device)
            t = _dryrun_target(x)
            out[name] = [float(dp.step(state, x, t)[1]) for _ in range(DRYRUN_STEPS)]
        out["launches"] = _build.launch_counts()
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException as e:  # reported to the parent, which raises
        results.put((rank, f"{type(e).__name__}: {e}"))
        raise


def spawn_ranks(target, n_ranks: int, args=(), timeout: float = 600.0) -> list:
    """Run `target(rank, n_ranks, address, *args, results)` in `n_ranks`
    spawned processes that meet at a file rendezvous; returns each rank's
    result, by rank. Raises when a rank fails, reports an error or outlives
    `timeout`; every process is ended before it returns."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        address = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=target, args=(r, n_ranks, address, *args, results))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout
        try:
            while len(got) < n_ranks:
                try:
                    rank, out = results.get(timeout=1.0)
                    if isinstance(out, str):
                        raise RuntimeError(f"rank {rank} failed: {out}")
                    got[rank] = out
                except queue.Empty:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"ranks {sorted(set(range(n_ranks)) - set(got))} "
                                           f"did not finish in {timeout} s") from None
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead and results.empty():
                        raise RuntimeError(f"a rank exited with code {dead[0]}")
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
    return [got[r] for r in range(n_ranks)]


def dryrun_multichip(n_ranks: int = 2, device="cuda") -> list:
    """A few data-parallel steps on `n_ranks` spawned ranks: config_hash
    under EMA(Adam) and PPNG3 (DRYRUN_CONFIGS), on `device` ("cuda": every
    rank on a card, NCCL when each has its own, else gloo on cards shared;
    "cpu": gloo). Prints "loss a -> b" per config and raises unless every
    loss is finite and falls; returns each rank's result."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is available")
        from ..ops.cuda import _build

        _build.library()  # built once here: the ranks only load it
        backend = "nccl" if torch.cuda.device_count() >= n_ranks else "gloo"
    else:
        backend = "gloo"
    outs = spawn_ranks(_dryrun_rank, n_ranks, (device.type, backend))
    for name in DRYRUN_CONFIGS:
        losses = outs[0][name]
        for r, out in enumerate(outs):
            if out[name] != losses:
                raise RuntimeError(f"dryrun {name}: rank {r}'s losses {out[name]} differ from "
                                   f"rank 0's {losses}")
        ok = all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0]
        print(f"dryrun_multichip({n_ranks}) {name} x{DRYRUN_STEPS} steps on {device.type} "
              f"({backend}): {'ok' if ok else 'FAILED'}; loss {losses[0]:.4e} -> {losses[-1]:.4e}",
              flush=True)
        if not ok:
            raise RuntimeError(f"dryrun {name}: the loss did not fall: {losses}")
    return outs
