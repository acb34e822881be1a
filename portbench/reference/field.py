"""Plain PyTorch reference of a neural field: a multiresolution hash grid
or a OneBlob encoding into a fully fused MLP, its losses and its
optimizers, written from the published descriptions (Instant-NGP,
arXiv:2201.05989, and tiny-cuda-nn's grid.h, oneblob.h, fully_fused_mlp.cu,
relative_l2.h and adam.h). It imports nothing of the program under test
and takes nothing the program made: the layout, the level tables and every
derived constant are worked out here again.

Everything runs in float32 with TF32 off (`strict_f32`). `precision="fp8"`
is the control: the same arithmetic with every value the program rounds to
bfloat16 (a grid's table it gathers, the encoding, each weight matrix and
each layer's output) rounded to float8 e4m3 instead, each tensor scaled by
its own largest magnitude, gradients passing straight through.
`precision="bf16"` rounds those values to bfloat16, as the program does: a
witness of what the rounding alone does, for the tests.

The flat parameter vector is tiny-cuda-nn's: [W_in | W_hidden... | W_out |
grid table] (no table after a OneBlob), each matrix row-major [fan_out,
fan_in], the input width the encoding's width padded to a multiple of 16
with zero columns, the output width padded to a multiple of 16 with rows
that the loss never reads.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

U32 = 0xFFFFFFFF
#: tiny-cuda-nn's CoherentPrime hash factors (common_device.h:647-661)
COHERENT_PRIMES = (1, 2654435761, 805459861, 3674653429)
ALIGN = 16
FP8_MAX = 448.0


@contextlib.contextmanager
def strict_f32():
    """Float32 matrix products in float32, not TF32, inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def next_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 at a scale that maps its largest
    magnitude to the format's largest value; the gradient passes through."""
    amax = t.detach().abs().max()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t.detach())


class Rounding:
    """Where the program rounds to bfloat16, the reference keeps float32
    and the control rounds to float8."""

    def __init__(self, precision: str):
        if precision not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.precision == "f32":
            return t
        if self.precision == "bf16":
            return t + (t.detach().to(torch.bfloat16).float() - t.detach())
        return round_fp8(t)


class HashGrid:
    """Instant-NGP's multiresolution grid (tiny-cuda-nn grid.h:652-1210):
    per level l the scale base * exp2(l * log2(per_level_scale)) - 1, the
    resolution ceil(scale) + 1, res^D rows (8-aligned) capped at
    2^log2_hashmap_size, a dense index while the uint32 stride product
    fits the level, else the CoherentPrime hash; positions x * scale + 0.5,
    linear weights, corners in bit order."""

    def __init__(self, n_dims: int, cfg: dict):
        otype = cfg.get("otype", "HashGrid")
        if otype not in ("HashGrid", "Grid") or cfg.get("type", "Hash") != "Hash":
            raise ValueError(f"the reference holds only hash grids, not {cfg}")
        for key in ("interpolation", "hash", "stochastic_interpolation"):
            if key in cfg and cfg[key] not in ("Linear", "CoherentPrime", False):
                raise ValueError(f"the reference holds only the default {key}")
        self.d = n_dims
        self.n_levels = int(cfg["n_levels"])
        self.f = int(cfg["n_features_per_level"])
        log2_t = int(cfg["log2_hashmap_size"])
        base = int(cfg["base_resolution"])
        log2_scale = math.log2(float(cfg["per_level_scale"]))
        self.offsets, self.sizes, self.scales, self.strides, self.hashed = [], [], [], [], []
        offset = 0
        for level in range(self.n_levels):
            scale = float(np.exp2(level * log2_scale) * base - 1.0)
            res = int(np.ceil(scale)) + 1
            size = min(next_multiple(min(res ** n_dims, 2 ** 31), 8), 1 << log2_t)
            stride, strides = 1, []
            for _ in range(n_dims):
                alive = stride <= size
                strides.append(stride if alive else 0)
                if alive:
                    stride = (stride * res) & U32
            self.offsets.append(offset)
            self.sizes.append(size)
            self.scales.append(scale)
            self.strides.append(strides)
            self.hashed.append(size < stride)
            offset += size
        self.rows = offset

    @property
    def n_params(self) -> int:
        return self.rows * self.f

    @property
    def width(self) -> int:
        return self.n_levels * self.f

    def leaves(self, start: int):
        """(name, begin, end) of each level's slice of the flat vector."""
        return [(f"level{l}", start + o * self.f, start + (o + s) * self.f)
                for l, (o, s) in enumerate(zip(self.offsets, self.sizes))]

    def _level_rows(self, level: int, cells: torch.Tensor) -> torch.Tensor:
        """Absolute rows int64 [N] of uint32 cells int64 [N, D] at `level`."""
        if self.hashed[level]:
            raw = torch.zeros_like(cells[:, 0])
            for dim in range(self.d):
                raw = raw ^ ((cells[:, dim] * COHERENT_PRIMES[dim]) & U32)
        else:
            raw = torch.zeros_like(cells[:, 0])
            for dim in range(self.d):
                raw = (raw + cells[:, dim] * self.strides[level][dim]) & U32
        return self.offsets[level] + raw % self.sizes[level]

    def encode(self, params: torch.Tensor, x: torch.Tensor, rnd: Rounding) -> torch.Tensor:
        """f32 [N, L*F], level-major and feature-minor; differentiable in
        the table `params` [rows * F] and `x` [N, D] to any order."""
        table = rnd(params.view(self.rows, self.f))
        out = []
        for level in range(self.n_levels):
            pos = x * torch.tensor(self.scales[level], dtype=torch.float32) + 0.5
            cell = torch.floor(pos.detach())
            frac = pos - cell
            cells = cell.to(torch.int64) & U32
            acc = 0.0
            for corner in range(1 << self.d):
                bits = [(corner >> dim) & 1 for dim in range(self.d)]
                w = 1.0
                for dim in range(self.d):
                    w = w * (frac[:, dim] if bits[dim] else 1.0 - frac[:, dim])
                rows = self._level_rows(level, cells + torch.tensor(bits, device=x.device))
                acc = acc + w[:, None] * table[rows]
            out.append(acc)
        return torch.cat(out, 1)


def quartic_cdf(t: torch.Tensor, inv_radius: float) -> torch.Tensor:
    """CDF of the quartic kernel 15/16 (1 - u^2)^2 of radius 1/inv_radius
    at t, clamped to [0, 1] (tiny-cuda-nn common_device.h, quartic_cdf)."""
    u = t * inv_radius
    u2 = u * u
    u4 = u2 * u2
    return torch.clamp(15.0 / 16.0 * u * (1.0 - 2.0 / 3.0 * u2 + 1.0 / 5.0 * u4) + 0.5, 0.0, 1.0)


class OneBlob:
    """tiny-cuda-nn's OneBlob (oneblob.h:46-96), no parameters: for each
    input dimension x and each of the n bins [k/n, (k+1)/n], the mass of
    the quartic kernel of radius 1/n centred at x that falls in the bin,
    the kernel wrapped around [0, 1] by its copies at x - 1 and x + 1:
    cdf((k+1)/n) - cdf(k/n), cdf(b) = quartic_cdf(b - x) + quartic_cdf(b -
    x - 1) + quartic_cdf(b - x + 1). Dimension-major, bins minor."""

    n_params = 0

    def __init__(self, n_dims: int, cfg: dict):
        self.d = n_dims
        self.n_bins = int(cfg.get("n_bins", 16))

    @property
    def width(self) -> int:
        return self.d * self.n_bins

    def leaves(self, start: int):
        return []

    def encode(self, params: torch.Tensor, x: torch.Tensor, rnd: Rounding) -> torch.Tensor:
        """f32 [N, D * n_bins] of `x` [N, D]; `params` is empty."""
        n = self.n_bins
        bounds = torch.arange(n + 1, device=x.device, dtype=torch.float32) / n
        t = bounds[None, None, :] - x[:, :, None]   # [N, D, n + 1]
        cdf = quartic_cdf(t, n) + quartic_cdf(t - 1.0, n) + quartic_cdf(t + 1.0, n)
        return (cdf[:, :, 1:] - cdf[:, :, :-1]).reshape(x.shape[0], self.width)


#: the reference's encoding of each `otype` a configuration here names
ENCODINGS = {"HashGrid": HashGrid, "Grid": HashGrid, "OneBlob": OneBlob}


class Mlp:
    """tiny-cuda-nn's FullyFusedMLP: ReLU hidden layers, no output
    activation, y = x @ W^T per layer."""

    def __init__(self, n_input: int, n_output: int, cfg: dict):
        if cfg.get("activation", "ReLU") != "ReLU" or cfg.get("output_activation", "None") != "None":
            raise ValueError("the reference holds ReLU hidden layers and a linear output")
        self.n_input, self.n_output = n_input, n_output
        w, h = int(cfg["n_neurons"]), int(cfg["n_hidden_layers"])
        self.in_width = next_multiple(n_input, ALIGN)
        self.out_width = next_multiple(n_output, ALIGN)
        self.shapes = [(w, self.in_width)] + [(w, w)] * (h - 1) + [(self.out_width, w)]
        self.n_params = sum(r * c for r, c in self.shapes)

    def leaves(self):
        out, off = [], 0
        for i, (r, c) in enumerate(self.shapes):
            out.append((f"layer{i}", off, off + r * c))
            off += r * c
        return out

    def init_scales(self):
        """Xavier-uniform bound of each matrix (gpu_matrix.h:284-379)."""
        return [math.sqrt(6.0 / (r + c)) for r, c in self.shapes]

    def apply(self, params: torch.Tensor, enc: torch.Tensor, rnd: Rounding) -> torch.Tensor:
        """f32 [N, n_output] of the encoding [N, n_input]."""
        h = torch.nn.functional.pad(enc, (0, self.in_width - enc.shape[1]))
        off = 0
        for i, (r, c) in enumerate(self.shapes):
            w = rnd(params[off : off + r * c].view(r, c))
            off += r * c
            h = rnd(h) @ w.T
            if i < len(self.shapes) - 1:
                h = torch.relu(h)
        return rnd(h)[:, : self.n_output]


class Field:
    """Encoding into MLP over one flat parameter vector [MLP | encoding]."""

    def __init__(self, cfg: dict, precision: str = "f32"):
        self.cfg = cfg
        otype = cfg["encoding"].get("otype")
        if otype not in ENCODINGS:
            raise ValueError(f"the reference holds the encodings {sorted(ENCODINGS)}, not {otype!r}")
        self.encoding = ENCODINGS[otype](int(cfg["n_input_dims"]), cfg["encoding"])
        self.mlp = Mlp(self.encoding.width, int(cfg["n_output_dims"]), cfg["network"])
        self.n_params = self.mlp.n_params + self.encoding.n_params
        self.rnd = Rounding(precision)

    def leaves(self):
        return self.mlp.leaves() + self.encoding.leaves(self.mlp.n_params)

    def forward(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        enc = self.rnd(self.encoding.encode(params[self.mlp.n_params :], x, self.rnd))
        return self.mlp.apply(params[: self.mlp.n_params], enc, self.rnd)

    def forward_blocks(self, params, x, block: int = 1 << 20) -> torch.Tensor:
        """`forward` in blocks of rows, without a graph."""
        with torch.no_grad():
            return torch.cat([self.forward(params, x[i : i + block])
                              for i in range(0, x.shape[0], block)])


def initial_params(field: Field, seed: int, table_scale: float, device) -> torch.Tensor:
    """Seeded f32 weights on `device` in two large calls: U(-1, 1) over the
    whole vector from a generator on the device, then scaled per leaf: each
    matrix to its Xavier bound, a grid's table to `table_scale`
    (tiny-cuda-nn initialises it at 1e-4)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(field.n_params, generator=gen, device=device) * 2.0 - 1.0
    scale = torch.full((field.n_params,), float(table_scale), device=device)
    for (_, b, e), s in zip(field.mlp.leaves(), field.mlp.init_scales()):
        scale[b:e] = s
    return u * scale


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def relative_l2(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """tiny-cuda-nn's RelativeL2 summed: (p - t)^2 / (p^2 + 0.01) / n with
    n = B * dims, the normaliser a constant to the gradient
    (relative_l2.h:66-75)."""
    n = target.numel()
    return ((pred - target) ** 2 / (pred.detach() ** 2 + 0.01)).sum() / n


def relative_l2_mean(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The binding sample's loss: mean((p - t)^2 / (sg(p)^2 + 0.01))."""
    return torch.mean((pred - target) ** 2 / (pred.detach() ** 2 + 0.01))


def sdf_true(p: torch.Tensor) -> torch.Tensor:
    """Signed distance of a sphere (radius 0.3) and a rounded box
    (half-size 0.22, rounding 0.05), both centred in the unit cube, merged
    by their minimum."""
    q = p - 0.5
    sphere = torch.linalg.vector_norm(q, dim=-1) - 0.3
    box = torch.linalg.vector_norm(torch.clamp_min(q.abs() - 0.22, 0.0), dim=-1) - 0.05
    return torch.minimum(sphere, box)


def sdf_loss(field: Field, params, xs, n_eikonal: int, weight: float) -> torch.Tensor:
    """mean((f - sdf)^2) over `xs` plus `weight` times the eikonal penalty
    mean((|df/dx| - 1)^2) over its first `n_eikonal` points, df/dx kept
    differentiable in the params."""
    data = torch.mean((field.forward(params, xs)[:, 0] - sdf_true(xs)) ** 2)
    xe = xs[:n_eikonal].detach().requires_grad_(True)
    (g,) = torch.autograd.grad(field.forward(params, xe)[:, 0].sum(), xe, create_graph=True)
    eik = torch.mean((torch.linalg.vector_norm(g, dim=-1) - 1.0) ** 2)
    return data + weight * eik


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
class TcnnAdam:
    """tiny-cuda-nn's Adam (adam.h:47-188) on a flat vector: L2 on the
    matrix weights only, a non-matrix weight with an exactly zero gradient
    skipped (no moment decay, no step), debiasing from each weight's own
    step count. Only the hyperparameters a configuration here sets."""

    KEYS = {"otype", "learning_rate", "beta1", "beta2", "epsilon", "l2_reg"}

    def __init__(self, cfg: dict, n_params: int, n_matrix: int, device):
        extra = set(cfg) - self.KEYS
        if extra or cfg.get("otype", "Adam") != "Adam":
            raise ValueError(f"the reference's Adam does not hold {sorted(extra)}")
        self.lr = float(cfg.get("learning_rate", 1e-3))
        self.b1 = float(cfg.get("beta1", 0.9))
        self.b2 = float(cfg.get("beta2", 0.999))
        self.eps = float(cfg.get("epsilon", 1e-8))
        self.l2 = float(cfg.get("l2_reg", 1e-8))
        self.matrix = torch.arange(n_params, device=device) < n_matrix
        self.m = torch.zeros(n_params, device=device)
        self.v = torch.zeros(n_params, device=device)
        self.t = torch.zeros(n_params, device=device)

    def step(self, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """The new weights for the gradient `g` the optimizer gets."""
        active = self.matrix | (g != 0)
        g = torch.where(self.matrix, g + self.l2 * w, g)
        m = self.b1 * self.m + (1 - self.b1) * g
        v = self.b2 * self.v + (1 - self.b2) * g * g
        self.t = self.t + active.float()
        lr = self.lr * torch.sqrt(1 - self.b2 ** self.t) / (1 - self.b1 ** self.t)
        new = w - lr / (torch.sqrt(v) + self.eps) * m
        self.m = torch.where(active, m, self.m)
        self.v = torch.where(active, v, self.v)
        return torch.where(active, new, w)

    def first_gradient(self) -> torch.Tensor:
        """The gradient the first step got, from its first moments."""
        return self.m / (1 - self.b1)


class TorchAdam:
    """torch.optim.Adam's update (no weight decay, no amsgrad), written
    out: every weight steps, debiasing from the global step."""

    def __init__(self, lr: float, betas, eps: float, n_params: int, device):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = torch.zeros(n_params, device=device)
        self.v = torch.zeros(n_params, device=device)
        self.t = 0

    def step(self, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        self.t += 1
        self.m = self.b1 * self.m + (1 - self.b1) * g
        self.v = self.b2 * self.v + (1 - self.b2) * g * g
        denom = torch.sqrt(self.v) / math.sqrt(1 - self.b2 ** self.t) + self.eps
        return w - self.lr / (1 - self.b1 ** self.t) * self.m / denom

    def first_gradient(self) -> torch.Tensor:
        return self.m / (1 - self.b1)
