"""The program's own kernels a traced step launches, by its launch counters (program counter)."""

from portbench.program import counted_per_unit


def read(run):
    return counted_per_unit(run, "launches.")
