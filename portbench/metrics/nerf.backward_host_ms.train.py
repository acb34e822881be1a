"""Host ms a traced NeRF step spends in the autograd pass from the loss into the flat gradient (program span)."""

from portbench.program import span_ms


def read(run):
    return span_ms(run, "tcnn.nerf.backward")
