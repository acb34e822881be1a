"""Rebuilds of K3's cached operands a traced frame (program counter)."""

from portbench.program import counted_per_unit


def read(run):
    return counted_per_unit(run, "k3.operands_rebuilt")
