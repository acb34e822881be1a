"""Host ms a traced NeRF step spends in the activations, the compositing over the rays and the loss, forward (program span)."""

from portbench.program import span_ms


def read(run):
    return span_ms(run, "tcnn.nerf.composite")
