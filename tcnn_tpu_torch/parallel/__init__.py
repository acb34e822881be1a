from .data_parallel import DataParallelTrainer, create_mesh, dryrun_multichip
from .distributed import (
    global_batch,
    global_mesh,
    host_shard_key,
    init_distributed,
)

__all__ = [
    "DataParallelTrainer",
    "create_mesh",
    "dryrun_multichip",
    "global_batch",
    "global_mesh",
    "host_shard_key",
    "init_distributed",
]
