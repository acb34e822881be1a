"""The plan of K4's and K6's private levels (tcnn_tpu_torch/ops/cuda/
grid_kernel.py:private_levels, train_kernel.py:train_layout), on the CPU.

K4 and K6 sum the table gradient of the leading dense levels in a block's
shared memory; the rest go to the global gradient by vector atomics. The
plan is pure Python, decided before any launch, and the kernels take it as
arguments, so a wrong plan (a hashed level kept private, a level past
max_level, more bytes than the block has) would be wrong on the card only.
These pin it: its choices at config_hash and the reference default, where
it stops, and that K6's layout with its private bytes fits the block's
shared memory for every model the fused train kernel takes.
"""

import json
import pathlib

import pytest

import tcnn_tpu_torch as tt
from tcnn_tpu_torch.ops.cuda import grid_kernel, mlp_kernel, train_kernel

REFERENCE = {"log2_hashmap_size": 19, "per_level_scale": 2.0}
CONFIG = pathlib.Path(__file__).resolve().parents[1] / "data" / "config_hash.json"


def _model(d=2, n_out=3, width=64, n_hidden=2, **enc):
    cfg = json.loads(json.dumps(tt.load_config(str(CONFIG))))
    cfg["encoding"].update(enc)
    cfg["network"].update(n_neurons=width, n_hidden_layers=n_hidden)
    return tt.create_from_config(d, n_out, cfg, device="cpu").network


@pytest.mark.parametrize("enc,k6,k4", [
    # levels 0-3 (5,160 rows) in K6's 82,688 spare bytes; K4 levels 0-4
    ({}, (128, 4, 5160 * 2), (5, 11728)),
    # 256, 1024, 4096 rows (43,008 bytes); level 3's 16,384 rows do not fit
    (REFERENCE, (128, 3, 5376 * 2), (3, 5376)),
])
def test_plan_at_config_hash_and_reference_default(enc, k6, k4):
    net = _model(**enc)
    dims = net.network.dims
    assert mlp_kernel.SMEM_OPTIN - mlp_kernel.bwd_smem_bytes(dims, 128) == 82_688
    assert train_kernel.train_layout(net) == k6
    plan = net.encoding.plan
    assert grid_kernel.private_levels(plan, plan.n_levels, grid_kernel.K4_PRIVATE_BYTES) == k4


def test_plan_never_reaches_a_hashed_level():
    plan = _model().encoding.plan  # levels 0-5 dense, 6-15 hashed
    assert plan.use_hash.index(True) == 6
    assert grid_kernel.private_levels(plan, 16, 1 << 40) == (6, sum(plan.sizes[:6]))
    dense = _model(type="Dense", n_levels=4, base_resolution=4).encoding.plan
    assert not any(dense.use_hash)
    assert grid_kernel.private_levels(dense, 4, 1 << 40) == (4, dense.total_rows)
    # a hashed level 0 (its dense size outgrows 2^10 rows): nothing is private
    first = _model(base_resolution=64, log2_hashmap_size=10).encoding.plan
    assert first.use_hash[0]
    assert grid_kernel.private_levels(first, 16, 1 << 40) == (0, 0)


def test_plan_cut_by_n_active():
    net = _model()
    plan = net.encoding.plan
    for n_active in range(5):
        p, rows = grid_kernel.private_levels(plan, n_active, 1 << 40)
        assert p == n_active and rows == plan.offsets[n_active]
    net.encoding.update_hyperparams({"max_level": 0.1})  # levels 0 and 1 kept
    assert net.encoding.active_levels() == 2
    assert train_kernel.train_layout(net) == (128, 2, plan.offsets[2] * plan.f)


def test_plan_empty_where_nothing_fits():
    plan = _model().encoding.plan
    level0 = plan.sizes[0] * plan.f * 4  # 2,048 bytes
    assert grid_kernel.private_levels(plan, 16, level0 - 1) == (0, 0)
    assert grid_kernel.private_levels(plan, 16, level0) == (1, plan.sizes[0])
    assert grid_kernel.private_levels(plan, 16, 0) == (0, 0)
    # a 128-wide, 5-hidden-layer MLP leaves K6 too little for level 0 at F = 8
    net = _model(width=128, n_hidden=5, n_features_per_level=8, base_resolution=64,
                 log2_hashmap_size=19)
    nt, p, priv = train_kernel.train_layout(net)
    spare = mlp_kernel.SMEM_OPTIN - mlp_kernel.bwd_smem_bytes(net.network.dims, nt)
    assert nt > 0 and p == 0 and priv == 0 and spare < net.encoding.plan.sizes[0] * 8 * 4


@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_k6_layout_fits_the_block(f, monkeypatch):
    """For every model the fused train kernel takes (here: D 2 and 3, F,
    every fused width, 1-5 hidden layers, T = 2^14 and 2^19, any max_level)
    and each K6_LAYOUT that scripts/time_k6_layouts.py times, the tile plus
    its private levels fit SMEM_OPTIN and, when any level is private, the
    layout's per-block budget; the private rows are whole unhashed levels
    from row 0, and none lies past n_active."""
    loss = tt.create_loss({"otype": "RelativeL2"})
    for d in (2, 3):
        for width in mlp_kernel.FUSED_WIDTHS:
            for n_hidden in (1, 2, 5):
                for log2 in (14, 19):
                    net = _model(d=d, width=width, n_hidden=n_hidden, n_features_per_level=f,
                                 log2_hashmap_size=log2, n_levels=8 if d == 3 else 16)
                    for max_level in (None, 0.3):
                        net.encoding.max_level = max_level
                        if not train_kernel.supported(net, loss):
                            continue
                        plan = net.encoding.plan
                        for max_nt, blocks in ((128, 1), (64, 2), (32, 4)):
                            monkeypatch.setattr(train_kernel, "K6_LAYOUT", (max_nt, blocks))
                            nt, p, priv = train_kernel.train_layout(net)
                            assert 0 < nt <= max_nt and 0 <= p <= net.encoding.active_levels()
                            assert not any(plan.use_hash[:p])
                            assert priv == plan.offsets[p] * f
                            used = mlp_kernel.bwd_smem_bytes(net.network.dims, nt,
                                                             priv_floats=priv)
                            assert used <= mlp_kernel.SMEM_OPTIN
                            budget = train_kernel.SMEM_SM // blocks - 1024
                            assert priv == 0 or used <= budget
