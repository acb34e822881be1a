"""Host ms a traced step spends preparing K6's operands, up to its launch (program span)."""

from portbench.program import span_ms


def read(run):
    return span_ms(run, "tcnn.k6.prepare")
