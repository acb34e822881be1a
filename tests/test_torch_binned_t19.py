"""The port's grid at the reference's default table size, T=2^19
(log2_hashmap_size 19, per_level_scale 2.0: grid.h:1148-1160, README.md:
28-41 of tiny-cuda-nn), where tcnn_tpu runs its trailing levels through
the binned route (B12), on the CPU (K1's and K4's twins):

  - the full 16-level 2-D default (5,592,320 rows; levels 6-11 hash, levels
    12-15 do not, because their uint32 stride res^2 wraps to 0, and at
    level 15 the row is pos0 mod 2^19): the index math bit-exact against
    tcnn_tpu's `_grid_indices` on every level, and the forward and table
    gradient against its XLA oracle at B = 512 (interpret mode is too slow
    for sixteen levels at this size);
  - a two-level T=2^19 grid (base resolution 2048, both levels binned) and
    test_binned_kernel.py's wrap-degenerate grid (level 1 at resolution
    2^16, its stride wrapped to 0, aliasing whole coordinate ranges into
    one row) against `grid_encode_split` in interpret mode, dropping no
    pick (asserted).

Tolerances: against `grid_encode_split`, tests/test_torch_binned.py's
(readings: the two-level grid bit-equal; the wrap-degenerate level, whose
aliased picks dedup into shared slots that the binned route rounds to
bf16 again, 1.5e-4, its forward within one bf16 ulp). Against XLA (an f32 table, f32
contributions): the forward rtol and atol 2^-8 (x max|table|), as
tests/test_torch_grid.py; the gradient norm-relative 2^-8, since the port
rounds each contribution to bf16 (at most 2^-9 of itself) and XLA does not
(reading 1.0e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from test_torch_binned import bf16_values, check_binned, enc_cfg, pair, port, rel

REFERENCE_DEFAULT = enc_cfg(n_levels=16, log2_hashmap_size=19)


def test_reference_default_layout_and_split():
    je, te = tc.create_encoding(2, REFERENCE_DEFAULT), tt.create_encoding(2, REFERENCE_DEFAULT)
    assert te._total_table_rows == je._total_table_rows == 5_592_320
    assert je._kernel_plan() is None  # past the dense kernels' cap: the binned route
    split = je._binned_split()
    assert split.n_prefix_levels == 6 and split.binned.n_levels == 10
    assert te.plan.use_hash == (False,) * 6 + (True,) * 6 + (False,) * 4
    for lvl in range(12, 16):  # the wrapped stride: (1, res), and res^2 = 0 mod 2^32
        assert te.plan.strides[lvl] == (1, 1 << (lvl + 4))
    assert te.n_params * 4 == 44_738_560  # f32 params; the bf16 table is half


def test_reference_default_indices_bit_exact_vs_jax():
    je, te = tc.create_encoding(2, REFERENCE_DEFAULT), tt.create_encoding(2, REFERENCE_DEFAULT)
    rng = np.random.default_rng(19)
    x = rng.uniform(-1.5, 2.5, (64, 2)).astype(np.float32)  # negative cells wrap too
    cells = np.floor(x[:, None, :] * te._scales[None, :, None] + 0.5).astype(np.int32)
    cells = cells.astype(np.uint32)[:, :, None, :]
    wide = rng.integers(0, 2**32, (64, 16, 1, 2), dtype=np.uint64).astype(np.uint32)
    cells = np.concatenate([cells, wide], axis=2)
    want = np.asarray(je._grid_indices(jnp.asarray(cells)))
    got = te._grid_indices(torch.from_numpy(cells.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    # level 15: pos1 drops out of the row entirely
    assert (want[:, 15] == (cells[:, 15, :, 0] % (1 << 19))).all()


def test_reference_default_matches_xla_oracle():
    je, te = tc.create_encoding(2, REFERENCE_DEFAULT), tt.create_encoding(2, REFERENCE_DEFAULT)
    rng = np.random.default_rng(20)
    p = rng.uniform(-1, 1, je.n_params).astype(np.float32)
    x = rng.uniform(0, 1, (512, 2)).astype(np.float32)
    gy = bf16_values(rng.normal(size=(512, te.n_output_dims)))
    f = lambda q: je.apply_unpadded(q, jnp.asarray(x), impl="xla", compute_dtype=jnp.float32)  # noqa: E731
    want, vjp = jax.vjp(f, jnp.asarray(p))
    (want_g,) = vjp(jnp.asarray(gy))
    got, got_g = port(te, p, x, gy)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2.0**-8, atol=2.0**-8 * np.abs(p).max())
    assert rel(got_g, np.asarray(want_g)) < 2.0**-8, rel(got_g, np.asarray(want_g))
    # every level took a gradient, the wrapped levels 12-15 included
    F = te.n_features_per_level
    for lvl in range(16):
        off, size = int(te._offsets[lvl]) * F, int(te._sizes[lvl]) * F
        assert np.abs(got_g[off : off + size]).sum() > 0, lvl


def test_two_level_t19_matches_grid_encode_split():
    je, te, split, p, x, gy = pair(2, enc_cfg(n_levels=2, base_resolution=2048,
                                              log2_hashmap_size=19), seed=21, batch=512)
    assert split.dense is None and split.binned.n_levels == 2 and split.binned.t_rows == 1 << 19
    check_binned(te, split, p, x, gy)


def test_wrap_degenerate_level_matches_grid_encode_split():
    cfg = {"otype": "HashGrid", "n_levels": 2, "n_features_per_level": 2,
           "log2_hashmap_size": 16, "base_resolution": 16, "per_level_scale": 4096.0}
    je, te, split, p, x, gy = pair(2, cfg, seed=22, batch=512, lo=0.0, hi=1.0)
    assert split.n_prefix_levels == 1 and split.binned.n_levels == 1
    assert te.plan.use_hash == (False, False) and te.plan.strides[1] == (1, 65536)
    check_binned(te, split, p, x, gy)
