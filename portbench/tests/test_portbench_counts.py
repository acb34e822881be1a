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


@pytest.mark.parametrize("name", ["hash_image", "sdf_grid"])
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
