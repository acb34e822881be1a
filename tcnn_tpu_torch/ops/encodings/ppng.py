"""PPNG1/2/3 encodings: frequency-modulated quantized feature tables with
rank decomposition (counterpart of ``tcnn_tpu/ops/encodings/ppng.py``; the
reference's ppng.h, ppng_1.h, ppng_2.h, ppng_3.h and interp.h).

For every frequency f in [0, F) and phase s in {0, 1}:

    freq_f = 2^(log2_min + f (log2_max - log2_min) / (F - 1)) * pi
    sc_i   = sin(freq_f (x_i - 0.5) + s pi / 2)
    p_i    = (sc_i + 1) / 2 (Q - 1);  p0 = clamp(floor(p)), p1 = clamp(ceil(p))
    w_i    = p_i - p0_i

and C output features per (f, s), F * 2 * C in all, level l = f * 2 + s.
The coordinates are torch code, differentiable in x; the table lookups are
kernels (``ops/cuda/ext_kernel.py``):

  - PPNG1: F * 2 * D one-dimensional tables of Q rows x C * R features. K10
    gathers both endpoints of every axis from the f32 params (the JAX
    package's one-hot einsum, ppng.py:185-210, is that gather); the lerp,
    the product over axes and the sum over ranks are torch code.
  - PPNG2: 3 * F * 2 plane tables of Q^2 rows x C * R features in the
    dense-ext layout of ppng.py:246-301. K10 gathers the 4 corners of each
    plane from a bf16 copy; the 8-corner rank-coupled combine
    (ppng.py:303-326) is torch code.
  - PPNG3: F * 2 dense tables of Q^3 rows x C features in the params' own
    (natural) row order; K12 computes the weighted sum over the 8 corners
    from a bf16 copy in one launch, K13 its backward.

Parameter gradients come through K11 (PPNG1/2) and K13 (PPNG3); input
gradients through the torch coordinate math and, for PPNG3, K13's dots.
Both compose to any order.

At compute dtype f32 every variant reads the f32 params, as the JAX
package's jnp route computes (ppng.py:185-210, 328-411, 599-638): K10
gathers PPNG2's plane corners and PPNG3's 8 corners from the f32 table
(K11 scatters their gradient), the combine and PPNG3's weighted corner sum
are torch code in f32, and the output stays f32. The JAX package's TPU-only machinery (PPNG2's
batch chunking, PPNG3's premixed rows and binned plan) is not ported.

Initialization: PPNG1/PPNG2 U(+-0.7) (ppng_1.h:324-327, ppng_2.h:451-454);
PPNG3 U(+-1e-4) (ppng.h:66-69). Factory defaults (ppng_1.h:340-378):
log2 freq 0..6, Q 64, F 6, C 4, rank 4; D must be 3.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F_

from ...common import COMPUTE_DTYPE
from ..cuda.ext_kernel import ExtGatherFn, ExtLookupFn, ExtSpec
from .base import Encoding

_HALF_PI = math.pi / 2.0
# the reference's single-precision pi literal (ppng_1.h:164)
_PI_F = 3.1415926535


class PPNGBase(Encoding):
    """Shared frequency/phase/quantization machinery of PPNG1/2/3."""

    pad_value = 0.0
    otype_name = "PPNG"
    #: U(+-init_scale) (ppng_1.h:326)
    init_scale = 0.7

    def __init__(
        self,
        n_dims_to_encode: int,
        log2_min_freq: int = 0,
        log2_max_freq: int = 6,
        n_quants: int = 64,
        n_frequencies: int = 6,
        n_features: int = 4,
        rank: int = 4,
    ):
        if n_dims_to_encode != 3:
            # ppng_1.h:372-377: only D=3 is instantiated
            raise ValueError(f"{self.otype_name}: n_dims_to_encode must be 3")
        super().__init__(n_dims_to_encode)
        self.log2_min_freq = int(log2_min_freq)
        self.log2_max_freq = int(log2_max_freq)
        self.n_quants = int(n_quants)
        self.n_frequencies = int(n_frequencies)
        self.n_features = int(n_features)
        self.rank = int(rank)
        self._validate()

    def _validate(self):
        if self.n_features not in (2, 4, 8):
            raise ValueError(f"{self.otype_name}: n_features must be 2, 4 or 8")
        if self.rank not in (2, 4, 8, 16):
            raise ValueError(f"{self.otype_name}: rank must be 2, 4, 8 or 16")

    @property
    def n_output_dims(self) -> int:
        return self.n_frequencies * 2 * self.n_features

    @property
    def n_levels(self) -> int:
        """(frequency, phase) pairs, l = f * 2 + s."""
        return self.n_frequencies * 2

    def init_params(self, generator: torch.Generator) -> torch.Tensor:
        s = self.init_scale
        return torch.empty(self.n_params, dtype=torch.float32).uniform_(-s, s, generator=generator)

    # -- shared math ----------------------------------------------------------
    def _frequencies(self) -> np.ndarray:
        """f32 [F]: exp2 in f64, cast to f32, times the f32 pi literal."""
        f = np.arange(self.n_frequencies, dtype=np.float64)
        lo, hi = self.log2_min_freq, self.log2_max_freq
        if self.n_frequencies > 1:
            base = f * (hi - lo) / (self.n_frequencies - 1) + lo
        else:
            base = np.full_like(f, lo)
        return np.exp2(base).astype(np.float32) * _PI_F

    def _quant_coords(self, x):
        """x [B, D] f32 -> (p0, p1 int64 [B, F, 2, D], w f32 [B, F, 2, D]),
        w differentiable in x (ppng.py:124-138)."""
        q = self.n_quants
        freqs = torch.from_numpy(self._frequencies()).to(x.device)
        phase = torch.tensor([0.0, _HALF_PI], dtype=torch.float32, device=x.device)
        arg = freqs[None, :, None, None] * (x[:, None, None, :] - 0.5) + phase[None, None, :, None]
        sc = torch.sin(arg)
        p = (sc + 1.0) * 0.5 * (q - 1)
        p0 = torch.clamp(torch.floor(p), 0, q - 1)
        p1 = torch.clamp(torch.ceil(p), 0, q - 1)
        w = p - p0
        return p0.detach().long(), p1.detach().long(), w

    # -- Encoding API ---------------------------------------------------------
    def spec_for(self, compute_dtype) -> ExtSpec:
        """`spec`, reading the tables in f32 at compute dtype f32."""
        if compute_dtype == torch.float32:
            return dataclasses.replace(self.spec, dtype=torch.float32)
        return self.spec

    def apply(self, params, x, *, max_level=None, compute_dtype=COMPUTE_DTYPE):
        """Encode and pad to `padded_output_width` with zeros, in
        `compute_dtype` (bf16 by default); differentiable in params and in
        x, to any order. `max_level` is accepted and ignored, as in the JAX
        package."""
        y = self.apply_unpadded(params, x, compute_dtype=compute_dtype)
        if self.n_to_pad:
            y = F_.pad(y, (0, self.n_to_pad), value=self.pad_value)
        return y

    def count_binned_drops(self, x) -> int:
        """Picks dropped by a binned lookup (the JAX package's TPU route can
        drop on slot overflow): the port's direct gathers never drop."""
        return 0

    def hyperparams(self):
        return {
            "otype": self.otype_name,
            "n_frequencies": self.n_frequencies,
            "log2_min_freq": self.log2_min_freq,
            "log2_max_freq": self.log2_max_freq,
            "n_quants": self.n_quants,
            "n_features_per_level": self.n_features,
            "rank": self.rank,
        }


class PPNG1Encoding(PPNGBase):
    """Rank-decomposed per-axis 1-D frequency-feature tables."""

    otype_name = "PPNG1"

    @property
    def n_params(self) -> int:
        # ppng_1.h:235: [F, 2, D, C, Q, R]
        return (self.n_frequencies * 2 * self.n_dims_to_encode * self.n_features
                * self.n_quants * self.rank)

    @property
    def spec(self) -> ExtSpec:
        """K = F*2*D tables of Q rows x C*R features, f32 as the einsum reads them."""
        K = self.n_levels * self.n_dims_to_encode
        return ExtSpec(K * self.n_quants, self.n_features * self.rank, torch.float32, K)

    def table(self, params):
        """params [F, 2, D, C, Q, R] -> flat [K * Q * C * R], rows k * Q + q
        (ppng.py:203-205)."""
        K, C, Q, R = self.spec.n_levels, self.n_features, self.n_quants, self.rank
        return params.reshape(K, C, Q, R).permute(0, 2, 1, 3).reshape(-1)

    def indices(self, x):
        """(idx int32 [B, 2 * K], col e * K + k for endpoint e of table
        k = (f * 2 + s) * D + d; w f32 [B, K])."""
        B = x.shape[0]
        K, Q = self.spec.n_levels, self.n_quants
        p0, p1, w = self._quant_coords(x.float())
        base = torch.arange(K, device=x.device) * Q
        idx = torch.cat([p0.reshape(B, K) + base, p1.reshape(B, K) + base], dim=1)
        return idx.to(torch.int32), w.reshape(B, K)

    def combine(self, picks, w, compute_dtype=COMPUTE_DTYPE):
        """Output [B, F*2*C] in `compute_dtype` from the raw endpoint picks
        [B, 2*K*C*R] (f32) and weights w [B, K]: the lerp per axis, the
        product over the D axes, the sum over ranks (ppng.py:206-210)."""
        B = picks.shape[0]
        F, D, C, R = self.n_frequencies, self.n_dims_to_encode, self.n_features, self.rank
        # unbind, not slices: its backward stacks the parts' gradients once,
        # where each slice's would fill a zero tensor of the whole input
        v0, v1 = picks.reshape(B, 2, self.spec.n_levels, C * R).unbind(1)
        w = w[..., None]
        l0, l1, l2 = ((1.0 - w) * v0 + w * v1).reshape(B, F, 2, D, C, R).unbind(3)
        return (l0 * l1 * l2).sum(-1).reshape(B, F * 2 * C).to(compute_dtype)

    def apply_unpadded(self, params, x, *, compute_dtype=COMPUTE_DTYPE):
        idx, w = self.indices(x)
        picks = ExtGatherFn.apply(self.table(params), idx, self.spec_for(compute_dtype))
        return self.combine(picks, w, compute_dtype)


class PPNG2Encoding(PPNGBase):
    """Rank-decomposed per-axis 2-D plane tables, trilinear corner mixing."""

    otype_name = "PPNG2"
    #: plane d's (row, column) axes: 0 -> (z, y), 1 -> (z, x), 2 -> (y, x)
    PLANES = ((2, 1), (2, 0), (1, 0))

    @property
    def n_params(self) -> int:
        # ppng_2.h:362: [F, 2, 3, C, Q, Q, R]
        return (self.n_frequencies * 2 * self.n_dims_to_encode * self.n_features
                * self.n_quants * self.n_quants * self.rank)

    @property
    def spec(self) -> ExtSpec:
        """NL = 3*F*2 planes of Q^2 rows x C*R features, read as bf16
        (dense_ext_kernel.pack_tables rounds them)."""
        NL = 3 * self.n_levels
        return ExtSpec(NL * self.n_quants**2, self.n_features * self.rank, torch.bfloat16, NL)

    def table(self, params):
        """params [F, 2, 3, C, Qr, Qc, R] -> flat, level l = d * F2 + fs,
        row q_row * Q + q_col, feature c * R + r (ppng.py:261-269)."""
        F, C, Q, R = self.n_frequencies, self.n_features, self.n_quants, self.rank
        return params.reshape(F, 2, 3, C, Q, Q, R).permute(2, 0, 1, 4, 5, 3, 6).reshape(-1)

    def indices(self, x):
        """(idx int32 [B, 4 * NL], col c * NL + l for plane corner
        c = bit_row * 2 + bit_col, global row l * Q^2 + p_row * Q + p_col;
        w f32 [B, F2, 3]) (ppng.py:282-297)."""
        B = x.shape[0]
        Q, F2 = self.n_quants, self.n_levels
        p0, p1, w = self._quant_coords(x.float())
        p = torch.stack([p0, p1], dim=-1).reshape(B, F2, 3, 2)
        lvl = torch.arange(3 * F2, device=x.device).reshape(3, F2) * (Q * Q)
        cols = []
        for c in range(4):
            br, bc = c >> 1, c & 1
            cols.append(torch.cat([lvl[d] + p[:, :, rd, br] * Q + p[:, :, cd, bc]
                                   for d, (rd, cd) in enumerate(self.PLANES)], dim=1))
        return torch.cat(cols, dim=1).to(torch.int32), w.reshape(B, F2, 3)

    def combine(self, picks, w, compute_dtype=COMPUTE_DTYPE):
        """Output [B, F2*C] in `compute_dtype` from the raw plane-corner
        picks [B, 4*NL*C*R] (bf16, or f32 at compute dtype f32) and weights
        w [B, F2, 3]: the 8-corner rank-coupled combine in f32
        (ppng.py:303-326)."""
        B = picks.shape[0]
        C, R, F2 = self.n_features, self.rank, self.n_levels
        CR = C * R
        # [corner][plane] -> [B, F2, CR], by unbind (see PPNG1Encoding.combine)
        planes = [c.unbind(1) for c in picks.float().reshape(B, 4, 3, F2, CR).unbind(1)]
        ws = [wd[..., None] for wd in w.unbind(-1)]

        def plane(d, br, bc):
            # plane d at corner (bit_row, bit_col)
            return planes[br * 2 + bc][d]

        def wexp(dim, bit):
            return ws[dim] if bit else 1.0 - ws[dim]

        out = torch.zeros((B, F2, CR), dtype=torch.float32, device=w.device)
        for corner in range(8):
            a, b2, c2 = (corner >> 2) & 1, (corner >> 1) & 1, corner & 1  # x, y, z bits
            weight = wexp(0, a) * wexp(1, b2) * wexp(2, c2)
            out = out + weight * (plane(0, c2, b2) * plane(1, c2, a) * plane(2, b2, a))
        return out.reshape(B, F2, C, R).sum(-1).reshape(B, F2 * C).to(compute_dtype)

    def apply_unpadded(self, params, x, *, compute_dtype=COMPUTE_DTYPE):
        idx, w = self.indices(x)
        picks = ExtGatherFn.apply(self.table(params), idx, self.spec_for(compute_dtype))
        return self.combine(picks, w, compute_dtype)


class PPNG3Encoding(PPNGBase):
    """Dense Q^D frequency-feature grid (rank 1), N-linear interpolation."""

    otype_name = "PPNG3"
    init_scale = 1e-4  # the base grid init (ppng.h:66-69)

    def __init__(self, n_dims_to_encode: int, **kw):
        kw.setdefault("rank", 1)
        super().__init__(n_dims_to_encode, **kw)

    def _validate(self):
        if self.n_features not in (1, 2, 4, 8):
            raise ValueError("PPNG3: n_features must be 1, 2, 4 or 8")
        if self.rank != 1:
            raise ValueError("PPNG3: rank is fixed at 1")

    @property
    def n_params(self) -> int:
        # ppng_3.h:488-493: [F, 2, Q^D, C]
        return self.n_frequencies * 2 * self.n_quants**self.n_dims_to_encode * self.n_features

    @property
    def spec(self) -> ExtSpec:
        """NL = F*2 tables of Q^D rows x C features, read as bf16."""
        rows = self.n_levels * self.n_quants**self.n_dims_to_encode
        return ExtSpec(rows, self.n_features, torch.bfloat16, self.n_levels)

    def table(self, params):
        """The params as the flat table: already level-major, natural row
        order sum_i p_i Q^i, feature-minor (ppng.py:580)."""
        return params

    def indices(self, x):
        """(idx int32 [B, 8 * NL], col c * NL + l, global row
        l * Q^D + sum_i p_i[bit_i(c)] * Q^i; cw f32 [B, 8 * NL] the product
        over i of w_i or 1 - w_i, differentiable in x) (_pick_natural,
        ppng.py:548-570)."""
        B = x.shape[0]
        D, Q, NL = self.n_dims_to_encode, self.n_quants, self.n_levels
        p0, p1, w = self._quant_coords(x.float())
        p = torch.stack([p0, p1], dim=-1)
        lvl = torch.arange(NL, device=x.device) * Q**D
        idx_cols, w_cols = [], []
        for c in range(1 << D):
            row = lvl
            weight = 1.0
            for i in range(D):
                bit = (c >> i) & 1
                row = row + p[..., i, bit].reshape(B, NL) * Q**i
                weight = weight * (w[..., i] if bit else 1.0 - w[..., i])
            idx_cols.append(row)
            w_cols.append(weight.reshape(B, NL))
        return torch.cat(idx_cols, dim=1).to(torch.int32), torch.cat(w_cols, dim=1)

    def apply_unpadded(self, params, x, *, compute_dtype=COMPUTE_DTYPE):
        idx, cw = self.indices(x)
        if compute_dtype != torch.float32:
            return ExtLookupFn.apply(self.table(params), cw, idx, self.spec)
        # f32: K10's corner rows from the f32 table, summed over the corners
        # in order in f32 (ppng.py:620-638)
        B, NL, C = x.shape[0], self.n_levels, self.n_features
        picks = ExtGatherFn.apply(self.table(params), idx, self.spec_for(compute_dtype))
        terms = (picks.reshape(B, -1, NL, C) * cw.reshape(B, -1, NL, 1)).unbind(1)
        out = terms[0]
        for t in terms[1:]:
            out = out + t
        return out.reshape(B, NL * C)
