"""K5 calls a traced step that took its split plan (dgrad, split-K weight gradient), by its counter (program counter);
nothing from a program that has no split plan."""

from portbench.program import counted_per_unit


def read(run):
    try:
        from tcnn_tpu_torch.ops.cuda import mlp_kernel
    except ImportError:
        return None
    if not hasattr(mlp_kernel, "mlp_bwd_plan"):
        return None
    return counted_per_unit(run, "k5.split")
