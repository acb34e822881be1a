"""Host ms a frame spends in inference outside its child spans: checks, gate, slice, cast (program span)."""

from portbench.program import span_ms


def read(run):
    return span_ms(run, "tcnn.inference", "self_s")
