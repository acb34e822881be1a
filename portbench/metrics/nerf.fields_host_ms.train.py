"""Host ms a traced NeRF step spends in its fields' forward: grid, density MLP, SH, colour MLP (program span)."""

from portbench.program import span_ms


def read(run):
    return span_ms(run, "tcnn.nerf.fields")
