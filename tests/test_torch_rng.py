"""The port's Rng hash (tcnn_tpu_torch/ops/pcg32.py) and the grid under
`"hash": "Rng"` (the twins of K1, K4, K7 and K8, ops/cuda/grid_kernel.py)
against tcnn_tpu and the reference's golden vectors, on the CPU.

Tolerances:
  - the hash and the table rows: exact (integer semantics are the contract);
  - the forward against tcnn_tpu's XLA route (f32 table): rtol and atol
    2^-8, as tests/test_torch_grid.py (the bf16 table and output);
  - the table gradient against tcnn_tpu's Pallas `_bwd_kernel` reading its
    precomputed hashes (interpret mode): rtol 1e-5 plus one bf16 ulp of the
    largest contribution, as tests/test_torch_grid_bwd.py;
  - the input-gradient twins against tcnn_tpu's Pallas input-gradient path:
    tests/test_torch_grid_ig.py's bounds.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu.ops import pcg32 as jax_pcg32
from tcnn_tpu.ops.pallas import grid_kernel as jax_grid_kernel
from tcnn_tpu_torch.common import HashType
from tcnn_tpu_torch.ops import pcg32
from tcnn_tpu_torch.ops.cuda import grid_kernel
from test_torch_grid import G
from test_torch_grid_bwd import _close, _jax_bwd
from test_torch_grid_ig import _enc_cfg as _ig_cfg
from test_torch_grid_ig import _inputs as _ig_inputs
from test_torch_grid_ig import _jax as _ig_jax
from test_torch_grid_ig import _port as _ig_port
from test_torch_grid_ig import _rel


def _enc_cfg(**kw):
    cfg = {"otype": "HashGrid", "n_levels": 5, "n_features_per_level": 2,
           "log2_hashmap_size": 8, "base_resolution": 4, "per_level_scale": 2.0,
           "hash": "Rng"}
    cfg.update(kw)
    return cfg


def _cells(d, seed, n=400):
    """Seeded uint32 cells [n, d] (int64 values) whose rows include 0, 2^31
    and 2^32 - 1 in every dimension and mixed."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 2**32, (n, d), dtype=np.uint64)
    for i, v in enumerate((0, 2**31, 2**32 - 1)):
        cells[i] = v
    cells[3:40] = rng.choice(np.array([0, 1, 2**31, 2**32 - 1], np.uint64), (37, d))
    return cells.astype(np.int64)


@pytest.mark.parametrize("d", [2, 3, 4])
def test_rng_hash_matches_golden(d):
    cells = torch.from_numpy(G[f"hash_cells_d{d}"].astype(np.int64))
    np.testing.assert_array_equal(pcg32.rng_hash(cells, d).numpy(), G[f"hash_rng_d{d}"][:, 0])


@pytest.mark.parametrize("d", [2, 3, 4])
def test_rng_hash_matches_jax_and_oracle(d):
    cells = _cells(d, seed=d)
    got = pcg32.rng_hash(torch.from_numpy(cells), d).numpy()
    want = np.asarray(jax_pcg32.rng_hash(jnp.asarray(cells.astype(np.uint32)), d))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    host = [pcg32.host_rng_hash(c, d) for c in cells]
    np.testing.assert_array_equal(got, host)
    assert host == [jax_pcg32.host_rng_hash(c, d) for c in cells]
    # another seed hashes otherwise (the card's control hashes with 1338)
    other = pcg32.rng_hash(torch.from_numpy(cells), d, seed=1338).numpy()
    assert (other != got).mean() > 0.95
    assert list(other[:8]) == [pcg32.host_rng_hash(c, d, seed=1338) for c in cells[:8]]


def test_advance_tables_match_jax():
    assert pcg32.advance_tables(1337) == jax_pcg32._advance_tables(1337)
    assert pcg32.host_pcg32_init(1337) == jax_pcg32.host_pcg32_init(1337)


@pytest.mark.parametrize("d", [2, 3, 4])
def test_rng_rows_match_jax(d):
    cfg = _enc_cfg(n_levels={2: 6, 3: 5, 4: 4}[d], base_resolution=16 if d == 2 else 4,
                   log2_hashmap_size={2: 10, 3: 8, 4: 10}[d])
    je, te = tc.create_encoding(d, cfg), tt.create_encoding(d, cfg)
    assert te.plan.rng and te.plan.c_hash()[-1] == grid_kernel.HASH_RNG
    assert any(te.plan.use_hash) and not all(te.plan.use_hash)  # dense and hashed levels
    rng = np.random.default_rng(d)
    x = rng.uniform(-1.5, 2.5, (64, d)).astype(np.float32)
    cells = np.floor(x[:, None, :] * te._scales[None, :, None] + 0.5).astype(np.int32)
    cells = cells.astype(np.uint32)[:, :, None, :]
    wide = rng.integers(0, 2**32, (64, te.n_levels, 1, d), dtype=np.uint64).astype(np.uint32)
    cells = np.concatenate([cells, wide], axis=2)
    want = np.asarray(je._grid_indices(jnp.asarray(cells)))
    got = te._grid_indices(torch.from_numpy(cells.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d,interp", [(2, "Linear"), (3, "Smoothstep"), (4, "Linear")])
def test_rng_forward_matches_xla(d, interp):
    cfg = _enc_cfg(interpolation=interp, n_levels=4, log2_hashmap_size=7)
    je, te = tc.create_encoding(d, cfg), tt.create_encoding(d, cfg)
    rng = np.random.default_rng(20 + d)
    p = rng.uniform(-1, 1, je.n_params).astype(np.float32)
    x = rng.uniform(-0.2, 1.2, (300, d)).astype(np.float32)
    want = np.asarray(je._apply_xla(jnp.asarray(p), jnp.asarray(x), compute_dtype=jnp.float32))
    got = te.apply_unpadded(torch.from_numpy(p), torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2.0**-8, atol=2.0**-8 * np.abs(p).max())


@pytest.mark.parametrize("d,interp", [(2, "Linear"), (3, "Smoothstep"), (2, "Nearest")])
def test_rng_table_gradient_matches_pallas(d, interp):
    cfg = _enc_cfg(interpolation=interp, n_levels=4, log2_hashmap_size=7)
    je, te = tc.create_encoding(d, cfg), tt.create_encoding(d, cfg)
    assert jax_grid_kernel.plan_for(je).ext_hash
    rng = np.random.default_rng(30 + d)
    x = rng.uniform(-0.2, 1.2, (300, d)).astype(np.float32)
    gy = np.array(jnp.asarray(rng.normal(size=(300, te.n_output_dims)), jnp.bfloat16)
                  .astype(jnp.float32))  # bf16 values, a writable copy
    want = _jax_bwd(je, x, gy)
    params = torch.zeros(te.n_params, requires_grad=True)
    te.apply_unpadded(params, torch.from_numpy(x)).backward(torch.from_numpy(gy).to(torch.bfloat16))
    _close(params.grad.numpy(), want, gy)


@pytest.mark.parametrize("interp,d", [("Linear", 2), ("Smoothstep", 3)])
def test_rng_input_gradient_twins_match_pallas_vjp(interp, d):
    """K7's and K8's twins hash through the same walker."""
    cfg = _ig_cfg(interpolation=interp, hash="Rng", log2_hashmap_size=6)
    je, te, p, x, gy, z, ct = _ig_inputs(d, cfg, seed=40 + d, lo=0.02, hi=0.98)
    assert te.plan.rng
    je._kernel_plan_cache = dataclasses.replace(je._kernel_plan(), batch_tile=256)
    (jg, jx), (jcp, jcx, jcg) = _ig_jax(je, p, x, gy, z, ct, "pallas")
    (pg, px), (pcg, pcp, pcx) = _ig_port(te, p, x, gy, z, ct)
    assert _rel(pg, jg) < 1e-4 and _rel(px, jx) < 1e-5
    assert _rel(pcp, jcp) < 1e-4 and _rel(pcx, jcx) < 1e-5
    assert _rel(torch.from_numpy(pcg).to(torch.bfloat16).float().numpy(), jcg) < 1e-5


def test_rng_forward_matches_pallas():
    cfg = _enc_cfg(n_levels=4, log2_hashmap_size=7)
    je, te = tc.create_encoding(3, cfg), tt.create_encoding(3, cfg)
    rng = np.random.default_rng(50)
    p = rng.uniform(-1, 1, je.n_params).astype(np.float32)
    x = rng.uniform(-0.2, 1.2, (300, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jax_grid_kernel.grid_encode_pallas(jax_grid_kernel.plan_for(je), jnp.asarray(p),
                                                  jnp.asarray(x))
    got = te.apply_unpadded(torch.from_numpy(p), torch.from_numpy(x)).float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    bad = np.abs(got - want) > 2.0**-7 * np.maximum(np.abs(got), np.abs(want))
    assert not bad.any(), f"{bad.sum()} values differ by more than one bf16 ulp"


def test_kernels_take_seed_1337_only():
    """The kernels hold the Rng tables and the draws' key for seed 1337; a
    plan with another seed (the card's controls) runs only in the twins."""
    te = tt.create_encoding(2, _enc_cfg())
    plan = te.plan
    x = torch.rand(50, 2)
    table = torch.rand(plan.total_rows, plan.f).to(torch.bfloat16)
    base = grid_kernel._grid_encode_plain(plan, table, x, plan.n_levels * plan.f, plan.n_levels)
    import copy

    other = copy.copy(plan)
    other.hash_seed = 1338
    moved = grid_kernel._grid_encode_plain(other, table, x, plan.n_levels * plan.f, plan.n_levels)
    L, F = plan.n_levels, plan.f
    hashed = [l for l in range(L) if plan.use_hash[l]]
    cols = [l * F + f for l in hashed for f in range(F)]
    assert not torch.equal(base[:, cols], moved[:, cols])
    dense = [l * F + f for l in range(L) if not plan.use_hash[l] for f in range(F)]
    assert torch.equal(base[:, dense], moved[:, dense])
    with pytest.raises(ValueError, match="seed 1337"):
        other.device_consts("cpu")
    assert plan.device_consts("cpu")[0].shape == (L, 8)
    assert HashType.Rng == te.hash_type
