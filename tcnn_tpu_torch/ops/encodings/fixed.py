"""Fixed-function (parameter-free) encodings.

Counterpart of ``tcnn_tpu/ops/encodings/fixed.py`` (the reference's
identity.h, empty.h, frequency.h, triangle_wave.h, oneblob.h and
spherical_harmonics.h). The JAX package writes them in plain jnp and has
no Pallas kernel for any of them, so they are plain torch here on every
device: autograd differentiates them to any order in x.

Each computes in f32 in the JAX package's op order (`encode_f32`, and the
module-level functions the tests call) and rounds to the compute dtype at
the end (bf16 by default, as the grid's output is bf16). Every one pads at the back with 1, except
SphericalHarmonics, which pads at the FRONT (spherical_harmonics.h:57-63),
a reference quirk the JAX package keeps.
"""

from __future__ import annotations

import abc
import math

import numpy as np
import torch
import torch.nn.functional as F

from ...common import COMPUTE_DTYPE, PI, quartic_cdf
from .base import Encoding


def frequency_encode(x, n_frequencies: int):
    """f32 [B, D] -> [B, D * n * 2]: sin, cos of 2^k pi x, input-dim-major,
    frequency next, (sin, cos) innermost (frequency.h:66-75)."""
    freqs = torch.from_numpy(2.0 ** np.arange(n_frequencies)).to(x.dtype).to(x.device)
    arg = x[:, :, None] * freqs[None, None, :] * PI  # [B, D, n]
    return torch.stack([torch.sin(arg), torch.cos(arg)], -1).reshape(x.shape[0], -1)


def triangle_wave_encode(x, n_frequencies: int):
    """f32 [B, D] -> [B, D * n]: |v - floor(v) - 0.5| * 4 - 1 of
    v = 2^(k-1) x + k / 4 (triangle_wave.h:69-76)."""
    k = np.arange(n_frequencies)
    scale = torch.from_numpy(2.0 ** (k - 1)).to(x.dtype).to(x.device)
    phase = torch.from_numpy(0.25 * k).to(x.dtype).to(x.device)
    val = x[:, :, None] * scale[None, None, :] + phase[None, None, :]
    out = torch.abs(val - torch.floor(val) - 0.5) * 4.0 - 1.0
    return out.reshape(x.shape[0], -1)


def oneblob_encode(x, n_bins: int):
    """f32 [B, D] -> [B, D * n_bins]: per bin k, wrapped_cdf((k+1)/n - x) -
    wrapped_cdf(k/n - x), the quartic kernel's CDF of radius 1/n wrapped
    around [0, 1] by its +-1 shifts (oneblob.h:70-96)."""
    n = int(n_bins)
    bounds = torch.from_numpy(np.arange(n + 1) / n).to(x.dtype).to(x.device)
    t = bounds[None, None, :] - x[:, :, None]  # [B, D, n+1]
    cdf = quartic_cdf(t, n) + quartic_cdf(t - 1.0, n) + quartic_cdf(t + 1.0, n)
    return (cdf[:, :, 1:] - cdf[:, :, :-1]).reshape(x.shape[0], -1)


def _sh_norm(l: int, m: int) -> float:
    """K_{l,m} = sqrt((2l+1)/(4 pi) * (l-|m|)!/(l+|m|)!)."""
    m = abs(m)
    return math.sqrt((2 * l + 1) / (4.0 * PI) * math.factorial(l - m) / math.factorial(l + m))


def sh_encode(xyz, degree: int):
    """Real spherical harmonics Y_l^m (Condon-Shortley phase) of a direction
    `xyz` [B, 3] in [-1, 1], l < degree, (l, m) row-major: the polynomial
    table of sh_enc (common_device.h:339-629) through the JAX package's
    recurrences. A_m + i B_m = (x + i y)^m; p_l^m(z) by the upward
    associated-Legendre recurrence with (-1)^m (2m-1)!! at l = m."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    ab = [(torch.ones_like(x), torch.zeros_like(x))]
    for _ in range(1, degree):
        a, b = ab[-1]
        ab.append((x * a - y * b, x * b + y * a))
    one = torch.ones_like(z)
    p = {}
    for m in range(degree):
        dfact = 1.0
        for i in range(1, 2 * m, 2):
            dfact *= i
        p[(m, m)] = ((-1.0) ** m) * dfact * one
        if m + 1 < degree:
            p[(m + 1, m)] = z * (2 * m + 1) * p[(m, m)]
        for l in range(m + 2, degree):
            p[(l, m)] = (z * (2 * l - 1) * p[(l - 1, m)] - (l + m - 1) * p[(l - 2, m)]) / (l - m)
    sqrt2 = math.sqrt(2.0)
    out = []
    for l in range(degree):
        for m in range(-l, l + 1):
            am, k = abs(m), _sh_norm(l, m)
            if m < 0:
                out.append(sqrt2 * k * ab[am][1] * p[(l, am)])
            elif m == 0:
                out.append(k * p[(l, 0)])
            else:
                out.append(sqrt2 * k * ab[am][0] * p[(l, am)])
    return torch.stack(out, -1)


class FixedEncoding(Encoding):
    """A parameter-free encoding: `encode_f32`, rounded to the compute
    dtype, padded with 1."""

    pad_value = 1.0

    @abc.abstractmethod
    def encode_f32(self, x):
        """f32 [B, n_dims_to_encode] -> f32 [B, n_output_dims]."""

    def apply_unpadded(self, params, x, *, compute_dtype=COMPUTE_DTYPE):
        return self.encode_f32(x).to(compute_dtype)


class IdentityEncoding(FixedEncoding):
    def __init__(self, n_dims_to_encode: int, scale: float = 1.0, offset: float = 0.0):
        super().__init__(n_dims_to_encode)
        self.scale = float(scale)
        self.offset = float(offset)

    @property
    def n_output_dims(self) -> int:
        return self.n_dims_to_encode

    def encode_f32(self, x):
        return x * self.scale + self.offset

    def hyperparams(self):
        return {"otype": "Identity", "scale": self.scale, "offset": self.offset}


class EmptyEncoding(FixedEncoding):
    """Zero-width output; a placeholder for unused input dims (empty.h:62)."""

    @property
    def n_output_dims(self) -> int:
        return 0

    def encode_f32(self, x):
        return torch.zeros((x.shape[0], 0), dtype=torch.float32, device=x.device)

    def hyperparams(self):
        return {"otype": "Empty"}


class FrequencyEncoding(FixedEncoding):
    def __init__(self, n_dims_to_encode: int, n_frequencies: int):
        super().__init__(n_dims_to_encode)
        self.n_frequencies = int(n_frequencies)

    @property
    def n_output_dims(self) -> int:
        return self.n_dims_to_encode * self.n_frequencies * 2

    def encode_f32(self, x):
        return frequency_encode(x, self.n_frequencies)

    def hyperparams(self):
        return {"otype": "Frequency", "n_frequencies": self.n_frequencies}


class TriangleWaveEncoding(FixedEncoding):
    def __init__(self, n_dims_to_encode: int, n_frequencies: int):
        super().__init__(n_dims_to_encode)
        self.n_frequencies = int(n_frequencies)

    @property
    def n_output_dims(self) -> int:
        return self.n_dims_to_encode * self.n_frequencies

    def encode_f32(self, x):
        return triangle_wave_encode(x, self.n_frequencies)

    def hyperparams(self):
        return {"otype": "TriangleWave", "n_frequencies": self.n_frequencies}


class OneBlobEncoding(FixedEncoding):
    def __init__(self, n_dims_to_encode: int, n_bins: int):
        super().__init__(n_dims_to_encode)
        self.n_bins = int(n_bins)

    @property
    def n_output_dims(self) -> int:
        return self.n_dims_to_encode * self.n_bins

    def encode_f32(self, x):
        return oneblob_encode(x, self.n_bins)

    def hyperparams(self):
        return {"otype": "OneBlob", "n_bins": self.n_bins}


class SphericalHarmonicsEncoding(FixedEncoding):
    """Real SH of degree <= 8 of a unit vector v stored as (v + 1) / 2
    (spherical_harmonics.h:103); pads at the FRONT with 1."""

    def __init__(self, n_dims_to_encode: int, degree: int):
        if n_dims_to_encode != 3:
            raise ValueError("SphericalHarmonics requires 3 input dims")
        if not 1 <= degree <= 8:
            raise ValueError("SphericalHarmonics degree must be in [1, 8]")
        super().__init__(n_dims_to_encode)
        self.degree = int(degree)

    @property
    def n_output_dims(self) -> int:
        return self.degree * self.degree

    def encode_f32(self, x):
        return sh_encode(x * 2.0 - 1.0, self.degree)

    def apply(self, params, x, *, compute_dtype=COMPUTE_DTYPE):
        y = self.apply_unpadded(params, x, compute_dtype=compute_dtype)
        if self.n_to_pad:
            y = F.pad(y, (self.n_to_pad, 0), value=self.pad_value)
        return y

    def hyperparams(self):
        return {"otype": "SphericalHarmonics", "degree": self.degree}
