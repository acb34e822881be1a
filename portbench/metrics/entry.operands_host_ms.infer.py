"""Host ms a frame spends on K3's operand cache: key, compare, any rebuild (program span)."""

from portbench.program import span_ms


def read(run):
    return span_ms(run, "tcnn.k3.operands")
