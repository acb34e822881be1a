"""The options of the port's grid kernels at a table size where tcnn_tpu
takes its binned route (B12), against `grid_encode_split` in interpret
mode, on the CPU: 3-D Smoothstep with the Prime hash, stochastic
interpolation (K4's stochastic option, whose binned counterpart is the
stochastic mode of `_place_kernel`), Nearest interpolation and the Rng
hash (K1's and K4's twins). One-level T=2^14 grids whose only level is
binned (base resolution 256 in 2-D, 32 in 3-D); the helpers and the
tolerances are tests/test_torch_binned.py's.

Stochastic: `grid_encode_split` slices one full-width draw across its dense
and binned parts (binned_kernel.py:313-330), so its corners are those of
the port's `stochastic_uniforms(B, L)`; each (sample, level)'s bf16 row
goes whole to that corner in both (reading: bit-equal gradients).
"""

import numpy as np
import pytest

from test_torch_binned import check_binned, enc_cfg, pair

# (label, D, encoding keys)
_CASES = [
    ("3-D Smoothstep Prime", 3, {"base_resolution": 32, "interpolation": "Smoothstep",
                                 "hash": "Prime"}),
    ("2-D Linear stochastic", 2, {"base_resolution": 256, "stochastic_interpolation": True}),
    ("2-D Nearest Rng", 2, {"base_resolution": 256, "interpolation": "Nearest", "hash": "Rng"}),
]


@pytest.mark.parametrize("label,d,kw", _CASES, ids=[c[0] for c in _CASES])
def test_options_match_grid_encode_split(label, d, kw):
    je, te, split, p, x, gy = pair(d, enc_cfg(n_levels=1, **kw), seed=len(label))
    assert split.dense is None and split.binned.n_levels == 1
    assert te.plan.stochastic == split.binned.sub.stochastic == ("stochastic" in label)
    assert te.plan.rng == ("Rng" in label)
    _, pg = check_binned(te, split, p, x, gy)
    if te.plan.stochastic:
        # one row per (sample, level): F values of the gradient's rows move
        assert np.count_nonzero(pg) <= x.shape[0] * te.n_output_dims
