"""Host ms a traced step spends in the optimizer's step (program span)."""

from portbench.program import span_ms


def read(run):
    return span_ms(run, "tcnn.optimizer.step")
