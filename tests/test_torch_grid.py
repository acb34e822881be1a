"""Parity of the port's grid encoding (tcnn_tpu_torch.ops.encodings.grid and
ops/cuda/grid_kernel.py) with the JAX package and the reference's golden
vectors, on the CPU, where the port runs kernel K1's plain twin.

Tolerances:
  - index math, hashes, cells: exact (integer semantics are the contract);
  - twin vs the JAX Pallas kernel (interpret mode): one bf16 ulp per value.
    Both read a bf16 table and round the f32 sum once to bf16; the Pallas
    kernel forms the corner weight as (1-w) + bit*(2w-1), which can differ
    from w in the last f32 bit and so flip a bf16 rounding;
  - twin vs the JAX XLA path (f32 table): rtol 2^-8 and atol 2^-8 * max|table|.
    Rounding the table to bf16 moves each row by at most 2^-9 of its size and
    the weights sum to 1, and the twin rounds its output to bf16 (2^-9
    relative); the bound doubles both for the f32 summation order.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu.ops.encodings.grid import GridEncoding as JaxGrid
from tcnn_tpu.ops.pallas.grid_kernel import grid_encode_pallas, plan_for
from tcnn_tpu_torch.common import GridType, HashType, InterpolationType
from tcnn_tpu_torch.ops.cuda import grid_kernel
from tcnn_tpu_torch.ops.encodings.grid import GridEncoding

G = np.load(pathlib.Path(__file__).parent / "golden" / "golden.npz")


def _enc_cfg(**kw):
    cfg = {
        "otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
        "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 2.0,
    }
    cfg.update(kw)
    return cfg


def _pair(d, cfg, seed):
    """The same encoding in both packages, one random table in [-1, 1]."""
    je = tc.create_encoding(d, cfg)
    te = tt.create_encoding(d, cfg)
    assert te.n_params == je.n_params
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, je.n_params).astype(np.float32)
    return je, te, p, rng


def _within_one_bf16_ulp(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    bad = np.abs(a - b) > 2.0**-7 * np.maximum(np.abs(a), np.abs(b))
    assert not bad.any(), f"{bad.sum()} values differ by more than one bf16 ulp"


# ---------------------------------------------------------------------------
# Golden vectors of the reference's own headers (tests/test_golden.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [2, 3, 4])
def test_prime_family_hashes_match_golden(d):
    cells = torch.from_numpy(G[f"hash_cells_d{d}"].astype(np.int64))
    for name, ht in [
        ("prime", HashType.Prime),
        ("coherent", HashType.CoherentPrime),
        ("reversed", HashType.ReversedPrime),
    ]:
        factors = grid_kernel.hash_factors(ht, d)
        got = torch.zeros(64, dtype=torch.int64)
        for dim in range(d):
            got = got ^ grid_kernel.mul_u32(cells[:, dim], factors[dim])
        np.testing.assert_array_equal(got.numpy(), G[f"hash_{name}_d{d}"][:, 0])


@pytest.mark.parametrize("d", [2, 3, 4])
def test_grid_index_matches_golden(d):
    sizes, ress, types = (G[k][:, 0] for k in ("gi_sizes", "gi_ress", "gi_types"))
    for cfg in range(len(sizes)):
        enc = GridEncoding(
            d, n_levels=2, log2_hashmap_size=19,
            grid_type=GridType.Dense if types[cfg] else GridType.Hash,
            hash_type=HashType.CoherentPrime,
        )
        enc._sizes = np.asarray([sizes[cfg]] * 2, np.uint32)
        enc._resolutions = np.asarray([ress[cfg]] * 2, np.uint32)
        cells = torch.from_numpy(G[f"gi_cells_c{cfg}_d{d}"].astype(np.int64))
        cells = cells[:, None, None, :].expand(64, 2, 1, d)
        got = enc._grid_indices(cells)[:, 0, 0]
        np.testing.assert_array_equal(
            got.numpy(), G[f"gi_out_c{cfg}_d{d}"][:, 0],
            err_msg=f"cfg={cfg} size={sizes[cfg]} res={ress[cfg]}",
        )


def test_pos_fract_matches_golden():
    x = torch.from_numpy(G["pf_x"])  # [128, D=1]
    scale = torch.from_numpy(G["pf_scale"])  # [128, L=1]
    cells, fract = grid_kernel.positions(x, scale, InterpolationType.Linear)
    np.testing.assert_array_equal(cells[:, 0, 0].numpy(), G["pf_grid_identity"][:, 0])
    np.testing.assert_allclose(fract[:, 0, 0].numpy(), G["pf_pos_identity"][:, 0], atol=1e-6)
    cells, ss = grid_kernel.positions(x, scale, InterpolationType.Smoothstep)
    np.testing.assert_array_equal(cells[:, 0, 0].numpy(), G["pf_grid_smoothstep"][:, 0])
    np.testing.assert_allclose(ss[:, 0, 0].numpy(), G["pf_pos_smoothstep"][:, 0], atol=1e-6)


# ---------------------------------------------------------------------------
# Index math against the JAX package, bit for bit on uint32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid_type", ["Hash", "Dense", "Tiled"])
@pytest.mark.parametrize("d", [2, 3, 4])
def test_grid_indices_bit_exact_vs_jax(grid_type, d):
    # base resolution 64 at scale 2: at D >= 3 the dense strides of the top
    # level wrap in uint32 (res^D > 2^32); hashed levels mix with dense ones.
    # Fewer levels at higher D keep the offset table inside uint32.
    cfg = _enc_cfg(type=grid_type, n_levels={2: 8, 3: 6, 4: 3}[d], base_resolution=64,
                   log2_hashmap_size=12, hash="Prime" if d == 3 else "CoherentPrime")
    je, te = tc.create_encoding(d, cfg), tt.create_encoding(d, cfg)
    rng = np.random.default_rng(d)
    # cells from x in [-1.5, 2.5] (negative cells wrap to large uint32) and
    # arbitrary uint32 cells
    x = rng.uniform(-1.5, 2.5, (64, d)).astype(np.float32)
    cells = np.floor(x[:, None, :] * te._scales[None, :, None] + 0.5).astype(np.int32)
    cells = cells.astype(np.uint32)[:, :, None, :]  # [B, L, C=1, D]
    wide = rng.integers(0, 2**32, (64, te.n_levels, 1, d), dtype=np.uint64)
    cells = np.concatenate([cells, wide.astype(np.uint32)], axis=2)
    want = np.asarray(je._grid_indices(jnp.asarray(cells)))
    got = te._grid_indices(torch.from_numpy(cells.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Forward against the JAX package
# ---------------------------------------------------------------------------

# Every grid type with every interpolation; D and F vary across the cases so
# each of D in {2, 3} and F in {1, 2, 4} runs (a covering set rather than the
# full product keeps the interpret-mode kernels well inside the time budget).
_FWD_CASES = [
    ("Hash", "Linear", 2, 2),
    ("Hash", "Smoothstep", 3, 1),
    ("Hash", "Nearest", 2, 4),
    ("Dense", "Linear", 3, 4),
    ("Dense", "Smoothstep", 2, 2),
    ("Dense", "Nearest", 3, 1),
    ("Tiled", "Linear", 2, 1),
    ("Tiled", "Smoothstep", 3, 2),
    ("Tiled", "Nearest", 2, 4),
    ("Hash", "Linear", 4, 2),  # D=4 runs the Pallas kernel at its 512-row tile
]


@pytest.mark.parametrize("grid_type,interp,d,f", _FWD_CASES)
def test_plain_forward_matches_pallas(grid_type, interp, d, f):
    cfg = _enc_cfg(type=grid_type, interpolation=interp, n_features_per_level=f)
    je, te, p, rng = _pair(d, cfg, seed=10 * d + f)
    x = rng.uniform(-0.2, 1.2, (300, d)).astype(np.float32)  # also outside [0, 1]
    with pltpu.force_tpu_interpret_mode():
        want = grid_encode_pallas(plan_for(je), jnp.asarray(p), jnp.asarray(x))
    got = te.apply_unpadded(torch.from_numpy(p), torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (300, te.n_output_dims)
    _within_one_bf16_ulp(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("grid_type,f", [("Hash", 2), ("Dense", 2), ("Tiled", 2), ("Hash", 8)])
def test_plain_forward_matches_xla_f32(grid_type, f):
    # F=8 is checked against the XLA oracle: the JAX fused kernels never ran it
    cfg = _enc_cfg(type=grid_type, interpolation="Smoothstep", n_levels=6, n_features_per_level=f)
    je, te, p, rng = _pair(3, cfg, seed=7)
    x = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    want = np.asarray(je._apply_xla(jnp.asarray(p), jnp.asarray(x), compute_dtype=jnp.float32))
    got = te.apply_unpadded(torch.from_numpy(p), torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2.0**-8, atol=2.0**-8 * np.abs(p).max())


@pytest.mark.parametrize("max_level", [0.0, 0.3, 0.5, 1.0])
def test_max_level_mask(max_level):
    cfg = _enc_cfg(n_levels=6)
    je, te, p, rng = _pair(2, cfg, seed=3)
    x = rng.uniform(0, 1, (200, 2)).astype(np.float32)
    want = np.asarray(
        je._apply_xla(jnp.asarray(p), jnp.asarray(x), compute_dtype=jnp.float32,
                      max_level=max_level)
    )
    got = te.apply_unpadded(torch.from_numpy(p), torch.from_numpy(x), max_level=max_level)
    got = got.float().numpy()
    n_active = te.active_levels(max_level)
    assert n_active == int(np.sum(np.arange(6) < max_level * 6 + 1e-3))
    F = te.n_features_per_level
    assert not got[:, n_active * F :].any()
    np.testing.assert_array_equal(want[:, n_active * F :], 0.0)
    np.testing.assert_allclose(got, want, rtol=2.0**-8, atol=2.0**-8 * np.abs(p).max())
    # the encoding's own attribute clamps the same way as the argument
    te.update_hyperparams({"max_level": max_level})
    again = te.apply_unpadded(torch.from_numpy(p), torch.from_numpy(x)).float().numpy()
    np.testing.assert_array_equal(again, got)


def test_apply_writes_zero_padding():
    enc = GridEncoding(2, n_levels=3, n_features_per_level=2, log2_hashmap_size=8)
    enc.set_alignment(16)
    assert enc.padded_output_width == 16
    p = enc.init_params(torch.Generator().manual_seed(0))
    assert p.dtype == torch.float32 and float(p.abs().max()) <= 1e-4
    x = torch.rand(37, 2)
    y = enc.apply(p, x)
    assert tuple(y.shape) == (37, 16) and y.dtype == torch.bfloat16
    assert not y[:, 6:].any()
    assert torch.equal(y[:, :6], enc.apply_unpadded(p, x))


def test_offsets_match_jax():
    for grid_type in GridType:
        for d in (2, 3, 4):
            kw = dict(n_levels=7, log2_hashmap_size=11, base_resolution=5, per_level_scale=1.7)
            je = JaxGrid(d, grid_type=tc.common.parse_grid_type(grid_type.value), **kw)
            te = GridEncoding(d, grid_type=grid_type, **kw)
            for name in ("_offsets", "_sizes", "_resolutions", "_scales"):
                np.testing.assert_array_equal(getattr(te, name), getattr(je, name))
            assert te.n_params == je.n_params


def test_rng_hash_is_not_ported():
    """The Rng hash, once refused, now encodes: its hashed levels' rows are
    tcnn_tpu's (tests/test_torch_rng.py holds the rest)."""
    enc = GridEncoding(2, n_levels=4, log2_hashmap_size=6, hash_type=HashType.Rng)
    je = JaxGrid(2, n_levels=4, log2_hashmap_size=6, hash_type=tc.common.HashType.Rng)
    x = torch.rand(40, 2)
    p = torch.rand(enc.n_params) * 2 - 1
    y = enc.apply(p, x)
    assert tuple(y.shape) == (40, enc.padded_output_width) and bool(torch.isfinite(y.float()).all())
    want = np.asarray(je._apply_xla(jnp.asarray(p.numpy()), jnp.asarray(x.numpy()),
                                    compute_dtype=jnp.float32))
    np.testing.assert_allclose(y[:, : enc.n_output_dims].float().numpy(), want,
                               rtol=2.0**-8, atol=2.0**-8)
