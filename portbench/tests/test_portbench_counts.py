"""The least-work counts against numbers worked by hand."""

import json
import pathlib

import pytest

import small  # noqa: F401  (the checkout's root on sys.path)
from portbench.counts import field as counts
from portbench.reference import field as ref

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_config_hash_shapes_by_hand():
    s = counts.Shapes.of(config("hash_image"))
    # 2 * (32*64 + 64*64 + 64*3) FLOPs a sample forward at the config's own widths
    assert 2 * s.mlp_macs == 12_672
    # 7168 MLP weights (64x32, 64x64, 16x64 with the output padded to 16)
    # and 354,296 table rows of 2 features
    assert s.rows == 354_296
    assert s.n_params == 7_168 + 2 * 354_296 == 715_760
    # 4 corners x 16 levels x (1 + 4) ops forward, as many for the table gradient
    assert s.grid_ops(1, "fwd", "bwd") == 4 * 16 * 10


def test_config_hash_train_step_at_2e18():
    w = counts.train_step(config("hash_image"), 1 << 18)
    assert w.mlp_flops == 3 * 12_672 * 2**18
    assert w.grid_ops == 640 * 2**18
    # x (2 floats) and targets (3) read, params read and gradient written
    assert w.bytes == 2**18 * 5 * 4 + 2 * 715_760 * 4
    ops_s = w.mlp_flops / 989e12 + w.grid_ops / 67e12
    assert w.least_seconds() == pytest.approx(max(w.bytes / 3.35e12, ops_s))
    assert w.least_seconds() == pytest.approx(12.58e-6, rel=1e-3)


def test_config_hash_frame_and_adam():
    w = counts.inference(config("hash_image"), 1920 * 1080)
    assert w.mlp_flops == 12_672 * 2_073_600
    assert w.bytes == 2_073_600 * 5 * 4 + 715_760 * 4
    assert counts.adam_seconds(715_760) == pytest.approx(7 * 4 * 715_760 / 3.35e12)


def test_sdf_counts_by_hand():
    c = config("sdf_grid")
    s = counts.Shapes.of(c)
    assert 2 * s.mlp_macs == 2 * (24 * 64 + 64 * 64 + 64 * 1) == 11_392
    # levels 0-4 dense (8, 12, 18, 28, 41 per side, 8-aligned), 7 levels capped
    # at 2^17; level 3's scale 8 * 1.5^3 - 1 reads 26.000000000000004 in
    # float64, so its resolution is ceil + 1 = 28, as the program's
    assert s.rows == 512 + 1728 + 5832 + 21_952 + 68_928 + 7 * 2**17
    w = counts.eikonal_step(c, 1 << 16, 1024)
    assert w.mlp_flops == 11_392 * (3 * 2**16 + 6 * 1024)
    # per corner, D = 3 and F = 2: fwd 2 + 4, bwd the same, ig 2 + 8 + 9, bwdbwd 9 + 6 + 27 + 18 + 12
    assert [s.grid_per_corner(k) for k in ("fwd", "bwd", "ig", "bwdbwd")] == [6, 6, 19, 72]


def test_ngp_image_shapes_by_hand():
    s = counts.Shapes.of(config("ngp_image"))
    # scale 2.0 from base 16: levels 0-5 dense at 16, 32, ..., 512 a side
    # (512^2 = 2^18 rows), levels 6-15 capped at 2^19
    assert s.rows == 256 + 1024 + 4096 + 16_384 + 65_536 + 262_144 + 10 * 2**19 == 5_592_320
    assert s.n_params == 7_168 + 2 * 5_592_320 == 11_191_808
    assert 2 * s.mlp_macs == 12_672
    w = counts.train_step(config("ngp_image"), 1 << 18)
    assert w.grid_ops == 640 * 2**18
    # the table read and its gradient written now bound the step: 90.8 MB
    assert w.bytes == 2**18 * 5 * 4 + 2 * 11_191_808 * 4
    assert w.least_seconds() == pytest.approx(w.bytes / 3.35e12)


def test_oneblob_image_counts_by_hand():
    c = config("oneblob_image")
    s = counts.Shapes.of(c)
    # 2 dims x 64 bins = 128 into five 128-wide layers and 3 outputs
    assert s.widths == (128, 128, 128, 128, 128, 128, 3)
    assert s.mlp_macs == 5 * 128 * 128 + 128 * 3 == 82_304
    # six matrices at padded widths 128-128x5-16, no table
    assert s.rows == 0 and s.n_params == 5 * 128 * 128 + 16 * 128 == 83_968
    # per dimension 65 boundaries of (offset, 2 wraps, 3 CDFs of 10, 2 sums)
    # and 64 differences
    assert s.fixed_ops == 2 * (65 * 35 + 64) == 4_678
    w = counts.train_step(c, 1 << 18)
    assert w.mlp_flops == 3 * 2 * 82_304 * 2**18
    assert w.grid_ops == 4_678 * 2**18
    assert w.mlp_flops / 989e12 == pytest.approx(130.9e-6, rel=1e-3)
    assert w.least_seconds() == pytest.approx(130.9e-6 + 18.30e-6, rel=1e-3)
    f = counts.inference(c, 1000)
    assert f.mlp_flops == 2 * 82_304 * 1000 and f.grid_ops == 4_678 * 1000


@pytest.mark.parametrize("name", ["hash_image", "sdf_grid", "ngp_image", "oneblob_image"])
def test_counts_reference_and_program_agree_on_the_layout(name):
    import tcnn_tpu_torch as tt

    c = config(name)
    blocks = {k: c[k] for k in ("loss", "optimizer", "encoding", "network")}
    model = tt.create_from_config(c["n_input_dims"], c["n_output_dims"], blocks, device="cpu")
    assert counts.Shapes.of(c).n_params == ref.Field(c).n_params == model.network.n_params
    assert ref.Field(c).mlp.shapes == [tuple(s) for s in model.network.layer_sizes()]


def test_hash_image_is_the_published_config():
    from tcnn_tpu_torch.config import load_config

    published = load_config(str(CONFIGS.parents[1] / "data" / "config_hash.json"))
    c = config("hash_image")
    for block in ("loss", "optimizer", "encoding", "network"):
        assert c[block] == published[block]


@pytest.mark.parametrize("name,published,grid", [
    ("oneblob_image", "config_oneblob.json", {}),
    # DOCUMENTATION.md's HashGrid defaults, where config_hash.json sets others
    ("ngp_image", "config_hash.json", {"log2_hashmap_size": 19, "per_level_scale": 2.0}),
])
def test_a_config_is_its_published_file(name, published, grid):
    p = json.loads((CONFIGS.parents[1] / "data" / published).read_text())
    c = config(name)
    for block in ("loss", "optimizer", "network"):
        assert c[block] == p[block]
    assert c["encoding"] == dict(p["encoding"], **grid)
    assert all(p["encoding"][k] != v for k, v in grid.items())
