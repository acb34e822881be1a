"""Host ms a step spends in training_step outside its child spans: checks, route gate (program span)."""

from portbench.program import span_ms


def read(run):
    return span_ms(run, "tcnn.training_step", "self_s")
