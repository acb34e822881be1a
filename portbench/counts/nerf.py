"""The least work of a NeRF training step (instant-ngp's configs/nerf/base.json:
a 3-D hash grid into a density MLP and a colour MLP, spherical harmonics
of the direction, compositing over ragged rays, the Huber loss), from the
configuration alone, on `field.py`'s peaks and rates. PERF.md derives each
count.
"""

from __future__ import annotations

from .field import F32, HBM_BYTES_PER_S, Shapes, Work, adam_seconds

#: bytes of a sample read: position (3 f32), direction (3 f32) and step dt
SAMPLE_BYTES = 7 * F32
#: bytes of a ray read: its target and background colours (3 f32 each) and
#: its int64 offset
RAY_BYTES = 6 * F32 + 8
DENSITY_OUTPUTS = 16
SH_OUTPUTS = 16
#: f32 operations of one sample's degree-4 spherical harmonics, forward
#: only (the direction takes no gradient): 2x - 1 on each dim (6), the
#: products xy, xz, yz, x^2, y^2, z^2 (6), then the 16 polynomials of
#: tiny-cuda-nn's table, 0, 1, 1, 1, 1, 1, 2, 1, 2, 4, 2, 4, 4, 4, 3, 4 (35)
SH4_OPS = 47
#: f32 operations of one sample's activations and compositing, forward:
#: exp of the density (1), sigmoid of 3 channels (3 x 3), tau = sigma dt
#: (1), the running sum (1), T = exp(-(sum - ray start)) (2), alpha =
#: 1 - exp(-tau) (2), w = T alpha (1), w c (3), the running sum of w c (3)
COMPOSITE_FWD_OPS = 23
#: and backward: dL/dc = w dC (3), dL/dw = c . dC (5), the sigmoids'
#: s (1 - s) g (6), dL/dtau through alpha and through the later samples'
#: T (its reverse running sum: 2, then 2), dtau/dsigma (1), dsigma/dh (1),
#: the running sums' own reverse sums (2)
COMPOSITE_BWD_OPS = 22
#: f32 operations of one ray's colour: T_end and the background (5), the
#: Huber loss of 3 channels (3 x 5) and its gradient (3 x 3)
RAY_OPS = 29


def _shapes(cfg: dict):
    """(the grid's Shapes, multiply-adds of one sample through both MLPs
    at their own widths: 16 density outputs, 3 colours)."""
    grid = Shapes.of({"n_input_dims": 3, "n_output_dims": DENSITY_OUTPUTS,
                      "encoding": cfg["encoding"], "network": cfg["network"]})
    colour = cfg["rgb_network"]
    width, hidden = int(colour["n_neurons"]), int(colour["n_hidden_layers"])
    widths = (DENSITY_OUTPUTS + SH_OUTPUTS,) + (width,) * hidden + (3,)
    macs = grid.mlp_macs + sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    return grid, macs


def n_params(cfg: dict) -> int:
    """The flat vector: both MLPs padded as they are stored, and the table."""
    grid, _ = _shapes(cfg)
    colour = cfg["rgb_network"]
    width, hidden = int(colour["n_neurons"]), int(colour["n_hidden_layers"])
    padded = (DENSITY_OUTPUTS + SH_OUTPUTS,) + (width,) * hidden + (16,)
    return grid.n_params + sum(a * b for a, b in zip(padded[:-1], padded[1:]))


def train_step(cfg: dict, samples: int, rays: float) -> Work:
    """A step over `samples` samples of `rays` rays: the samples and rays
    read, the parameters read and their gradient written once; both MLPs
    forward, input gradient and weight gradient (3x forward); the grid's
    forward and table gradient; SH forward; compositing forward and
    backward; each ray's colour and loss."""
    grid, macs = _shapes(cfg)
    nbytes = samples * SAMPLE_BYTES + rays * RAY_BYTES + 2 * n_params(cfg) * F32
    ops = (grid.grid_ops(samples, "fwd", "bwd")
           + samples * (SH4_OPS + COMPOSITE_FWD_OPS + COMPOSITE_BWD_OPS) + rays * RAY_OPS)
    return Work(nbytes, 3 * 2.0 * macs * samples, ops)


def chain_seconds(n: int) -> float:
    """The chain's least time: Adam's (`field.adam_seconds`), and EMA's
    parameters and average read and its average written, f32."""
    return adam_seconds(n) + 3 * F32 * n / HBM_BYTES_PER_S
