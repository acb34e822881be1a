"""The least work of a neural field's step, worked out from its
configuration alone, whatever route the program takes: the bytes each step
has to move at the least and the operations it has to compute. The least
time of a step is the larger of its bytes over the memory rate and its
operations over their peaks (`least_seconds`). PERF.md derives each count.

Peaks are NVIDIA's data sheet figures for the H100 SXM (dense, no
sparsity).
"""

from __future__ import annotations

import dataclasses
import math

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
F32 = 4


def next_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class Work:
    """Least work of one unit (a step or a frame)."""

    bytes: float
    mlp_flops: float   # tensor-core products, against PEAK_BF16
    grid_ops: float    # the encoding's arithmetic (a grid's interpolation, OneBlob's
                       # kernel), against PEAK_F32

    @property
    def flops(self) -> float:
        return self.mlp_flops + self.grid_ops

    def least_seconds(self) -> float:
        return max(self.bytes / HBM_BYTES_PER_S,
                   self.mlp_flops / PEAK_BF16 + self.grid_ops / PEAK_F32)


#: f32 operations of one quartic_cdf: the scaled argument, its square and
#: fourth power, the polynomial (2 multiplies, 2 adds), the factor u, 15/16
#: and + 0.5 (the clamp not counted)
QUARTIC_CDF_OPS = 10


def oneblob_ops(d: int, n_bins: int) -> int:
    """f32 operations of one sample's OneBlob forward: per dimension its
    n + 1 bin boundaries (the first CDF is kept for the next bin), each the
    offset b - x, its two wrapped copies (2), three CDFs and their sum (2),
    and the n differences."""
    return d * ((n_bins + 1) * (1 + 2 + 3 * QUARTIC_CDF_OPS + 2) + n_bins)


@dataclasses.dataclass(frozen=True)
class Shapes:
    """The sizes of an encoding + MLP configuration that the counts read
    (a OneBlob has no levels, features or rows)."""

    d: int
    levels: int
    features: int
    rows: int
    widths: tuple   # the MLP's own widths: encoding, hidden..., outputs
    n_params: int   # the flat vector, padding included
    fixed_ops: int = 0   # f32 operations of one sample's parameter-free encoding

    @classmethod
    def of(cls, cfg: dict) -> "Shapes":
        enc, net = cfg["encoding"], cfg["network"]
        d = int(cfg["n_input_dims"])
        if enc["otype"] == "OneBlob":
            n_bins = int(enc.get("n_bins", 16))
            levels, f, rows, enc_width, fixed = 0, 0, 0, d * n_bins, oneblob_ops(d, n_bins)
        else:
            levels, f = int(enc["n_levels"]), int(enc["n_features_per_level"])
            base, cap = int(enc["base_resolution"]), 1 << int(enc["log2_hashmap_size"])
            log2_scale = math.log2(float(enc["per_level_scale"]))
            rows = 0
            for level in range(levels):
                res = math.ceil(2.0 ** (level * log2_scale) * base - 1.0) + 1
                rows += min(next_multiple(min(res ** d, 2 ** 31), 8), cap)
            enc_width, fixed = levels * f, 0
        width, hidden = int(net["n_neurons"]), int(net["n_hidden_layers"])
        n_out = int(cfg["n_output_dims"])
        widths = (enc_width,) + (width,) * hidden + (n_out,)
        padded = (next_multiple(enc_width, 16),) + (width,) * hidden + (next_multiple(n_out, 16),)
        n_mlp = sum(a * b for a, b in zip(padded[:-1], padded[1:]))
        return cls(d, levels, f, rows, widths, n_mlp + rows * f, fixed)

    @property
    def mlp_macs(self) -> int:
        """Multiply-adds of one sample's forward at the configuration's widths."""
        return sum(a * b for a, b in zip(self.widths[:-1], self.widths[1:]))

    def grid_per_corner(self, kind: str) -> int:
        """f32 operations per (sample, level, corner): the corner weight
        (D - 1 multiplies) and the weighted row (2F) forward; the same for
        the table gradient; with input gradients 2F more for the feature
        dot and D^2 for dW/dx; the second order's zw (2D), d2W (D^3),
        hessian sums (2D^2), ct_gy (2F), dot (2F) and scatter (2F)."""
        d, f = self.d, self.features
        return {"fwd": d - 1 + 2 * f, "bwd": d - 1 + 2 * f, "ig": d - 1 + 4 * f + d * d,
                "bwdbwd": d * d + 2 * d + d ** 3 + 2 * d * d + 6 * f}[kind]

    def grid_ops(self, n: int, *kinds: str) -> float:
        return float(n) * self.levels * (1 << self.d) * sum(self.grid_per_corner(k) for k in kinds)

    def encoding_ops(self, n: int, *kinds: str) -> float:
        """`grid_ops`, and a parameter-free encoding's forward (it has no
        table gradient; a grid adds 0)."""
        return self.grid_ops(n, *kinds) + float(n) * self.fixed_ops


def train_step(cfg: dict, batch: int) -> Work:
    """A supervised step: inputs and targets read, the parameters read and
    their gradient written once; the encoding's forward and a grid's table
    gradient; the MLP forward, its input gradient and its weight gradient
    (3x forward)."""
    s = Shapes.of(cfg)
    n_out = int(cfg["n_output_dims"])
    nbytes = batch * (s.d + n_out) * F32 + 2 * s.n_params * F32
    return Work(nbytes, 3 * 2.0 * s.mlp_macs * batch, s.encoding_ops(batch, "fwd", "bwd"))


def eikonal_step(cfg: dict, batch: int, n_eikonal: int) -> Work:
    """An SDF step: `train_step`'s work on the data term (its target is
    computed from x, so only x is read); on the eikonal points the forward
    (1x), the input gradient (1x) and the parameter gradient of both
    through second order (4x), the grid's forward, input gradient and
    double backward."""
    s = Shapes.of(cfg)
    nbytes = batch * s.d * F32 + 2 * s.n_params * F32
    flops = 2.0 * s.mlp_macs * (3 * batch + 6 * n_eikonal)
    ops = s.grid_ops(batch, "fwd", "bwd") + s.grid_ops(n_eikonal, "fwd", "ig", "bwdbwd")
    return Work(nbytes, flops, ops)


def inference(cfg: dict, queries: int) -> Work:
    """A frame: the queries read, the parameters read once, the outputs
    written (f32); the encoding and MLP forward."""
    s = Shapes.of(cfg)
    n_out = int(cfg["n_output_dims"])
    nbytes = queries * (s.d + n_out) * F32 + s.n_params * F32
    return Work(nbytes, 2.0 * s.mlp_macs * queries, s.encoding_ops(queries, "fwd"))


def adam_seconds(n_params: int) -> float:
    """Adam's least time: params, gradients, first and second moments read,
    params and both moments written, f32."""
    return 7 * F32 * n_params / HBM_BYTES_PER_S
