"""Host ms a traced frame spends in K3's calls: checks, output, consts, the ctypes call (program span)."""

from portbench.program import span_ms


def read(run):
    return span_ms(run, "tcnn.k3.launch")
