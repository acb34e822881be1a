"""Host ms a traced step spends in K6's launch, the ctypes call and its check (program span)."""

from portbench.program import span_ms


def read(run):
    return span_ms(run, "tcnn.k6.launch")
