"""Multi-process entry points on `torch.distributed` (counterpart of
``tcnn_tpu/parallel/distributed.py``).

The reference is strictly single-GPU. Here every rank runs the same
program, one process per rank: `init_distributed` joins it to the process
group, `global_mesh` spans all ranks, and `DataParallelTrainer.step` runs
unchanged on each. Each rank generates its own shard of the global batch
on its device: `host_shard_key` gives it a generator whose stream differs
per (rank, step), and `global_batch` checks the shard against the global
batch size without moving data across ranks.

Nothing tells a program of a cluster: pass the coordinator's address
(``"host:port"``, ``"tcp://host:port"`` or a ``"file://"`` rendezvous), the
world size and the rank, or launch under torchrun, whose environment
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK) is read when they
are not given.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

#: SplitMix64's increment and mixing constants (Steele et al. 2014).
_GOLDEN = 0x9E3779B97F4A7C15
_M64 = (1 << 64) - 1


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, local_device_ids=None,
                     backend: str | None = None) -> tuple[int, int]:
    """Join this process to the process group; returns (rank, world size).

    A no-op when a process group exists. Without a coordinator (no
    argument, no MASTER_ADDR) the process runs alone: (0, 1), no group.
    `backend` defaults to "nccl" where CUDA is available and "gloo"
    elsewhere; NCCL refuses two ranks on one card, so ranks that share a
    card take "gloo" (its collectives take CUDA tensors). Where CUDA is
    available the rank's card is set current: `local_device_ids[0]`, else
    LOCAL_RANK, else the rank."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes need a coordinator_address")
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator_address needs num_processes and process_id")
    if torch.cuda.is_available():
        local = (local_device_ids[0] if local_device_ids
                 else int(env.get("LOCAL_RANK", process_id)))
        torch.cuda.set_device(local)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def mesh_device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def global_mesh(axis_name: str = "data") -> DeviceMesh:
    """1-D data mesh over all ranks of the process group."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed with a coordinator first")
    return DeviceMesh(mesh_device_type(), list(range(dist.get_world_size())),
                      mesh_dim_names=(axis_name,))


def _mix(z: int) -> int:
    """SplitMix64's output function."""
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed that mixes `data` into `seed` (jax.random.fold_in's
    role; another function of the two)."""
    return _mix((_mix((seed + _GOLDEN) & _M64) + (data & _M64) * _GOLDEN) & _M64) >> 1


def host_shard_key(seed: int, step_or_unique: int = 0, device="cuda") -> torch.Generator:
    """A generator on `device` whose stream differs per (rank, step): the
    rank folded into `seed`, then the step, so that each rank draws a
    distinct shard of the global batch (tcnn_tpu's host_shard_key)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.Generator(device=device).manual_seed(
        fold_in(fold_in(int(seed), rank), int(step_or_unique)))


def global_batch(mesh: DeviceMesh, local_tensors, global_batch_size: int):
    """This rank's shard of a global batch, on its device: checks that each
    tensor's rows times the mesh's size make `global_batch_size` and moves
    no data across ranks (each rank holds only its own rows)."""
    n = mesh.size()
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    out = []
    for t in local_tensors:
        t = torch.as_tensor(t)
        if t.shape[0] * n != global_batch_size:
            raise ValueError(f"{t.shape[0]} rows a rank x {n} ranks != global batch "
                             f"{global_batch_size}")
        out.append(t.to(device))
    return tuple(out)
