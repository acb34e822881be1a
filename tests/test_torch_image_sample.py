"""The port's image sample (tcnn_tpu_torch/samples/mlp_learning_an_image.py)
and its utilities, and the Trainer at the reference-default T=2^19 hash
grid, against tcnn_tpu on the CPU.

  - `pixel_center_coords` bit-equal to tcnn_tpu's; `save_image` and
    `load_image` through PIL;
  - the sample's `train` and `render` at a small batch and image, its
    refusal of no GPU without `device="cpu"`, and its native pipeline
    (`--native-pipeline`): the first batch bit-equal to
    `tcnn_tpu.native.HostRng(1337).image_batch`, a few steps on it;
  - one `training_step` of the full 2-D reference default (5,592,320 rows,
    the grid tcnn_tpu runs on its binned route on a TPU) on the port's
    composed route (K1 K2 K5 K4 twins) against tcnn_tpu's Trainer step on
    the CPU (its XLA composed route) from the same flat params;
  - a port snapshot with its optimizer block loaded into tcnn_tpu's Trainer
    (a 3-level T=2^19 grid, past tcnn_tpu's one-hot cap), giving the same
    predictions and the same next step.

Tolerances. Port against tcnn_tpu's XLA route, which keeps an f32 table
and f32 contributions where the port reads a bf16 table (2^-9 relative
per row) and rounds each contribution w * g to bf16; both round g to bf16
at the loss and at every MLP layer, each in its own order:
  - the loss rtol 2^-8 (readings 2.2e-4, 3.3e-5);
  - after one Adam step, the moments norm-relative 2^-5 (readings: first
    8.9e-3 and 1.7e-3, second 4.1e-3 and 6.9e-4). At T=2^10
    (tests/test_torch_train.py) many contributions share each row and
    their rounding averages out to 2e-3; at T=2^19 a fine level's row
    holds one or two, and the table gradient carries the difference whole;
  - the step: of the params either side moved, at most STEP_OFF_MAX =
    2.5% apart by more than lr/10 (readings 0.81% and 0.18% of 63,104 and
    18,412 moved; each of them a sign flip). Only the params a 512-sample
    batch touches move, by about lr each, and the few whose gradient lies
    within the rounding of zero move the other way, so the step's
    norm-relative difference (0.18, 0.09) is not bounded;
  - predictions: 2^-5 * max|y|, as tests/test_torch_slice.py holds the
    port against the XLA route (reading 5.9e-3).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu import native as jax_native
from tcnn_tpu.utils import image as jax_image
from tcnn_tpu_torch.samples import mlp_learning_an_image as sample
from tcnn_tpu_torch.utils import image

LR = 1e-2
STEP_OFF_MAX = 0.025
REFERENCE_CONFIG = tt.load_config(str(sample.DEFAULT_CONFIG))
REFERENCE_CONFIG["encoding"].update(log2_hashmap_size=19, per_level_scale=2.0)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("h,w", [(37, 53), (1024, 768), (1, 1)])
def test_pixel_center_coords_bit_equal_to_jax(h, w):
    got = image.pixel_center_coords(h, w, device="cpu")
    want = jax_image.pixel_center_coords(h, w)
    assert got.dtype == torch.float32 and tuple(got.shape) == (h * w, 2)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_save_and_load_image_round_trip(tmp_path):
    img = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (17, 23, 3)) / 255.0).float()
    path = str(tmp_path / "img.png")
    image.save_image(path, img)
    back = image.load_image(path)
    assert back.dtype == torch.float32 and tuple(back.shape) == (17, 23, 3)
    torch.testing.assert_close(back, img, rtol=0, atol=1e-6)
    # the same file as tcnn_tpu writes, and read back the same
    jax_image.save_image(str(tmp_path / "jax.png"), img.numpy())
    assert (tmp_path / "jax.png").read_bytes() == (tmp_path / "img.png").read_bytes()
    np.testing.assert_array_equal(back.numpy(), jax_image.load_image(path))


def test_train_and_render_on_the_cpu(tmp_path):
    """config_hash (T=2^15): the CPU's twins take seconds a step at T=2^19."""
    img = image.synthetic_image(64, 64, device="cpu")
    cfg = tt.load_config(str(sample.DEFAULT_CONFIG))
    model, losses = sample.train(cfg, img, 40, device="cpu", batch=4096, log=None)
    assert losses.shape == (40,) and bool(torch.isfinite(losses).all())
    assert float(losses[0] / losses[-5:].mean()) > 20, losses
    pred = sample.render(model.trainer, 64, 64, chunk=1000)  # five chunks, the last short
    assert tuple(pred.shape) == (64, 64, 3) and bool(torch.isfinite(pred).all())
    whole = model.trainer.inference(image.pixel_center_coords(64, 64, device="cpu"))
    assert torch.equal(pred.reshape(-1, 3), whole)
    assert image.psnr(pred, img) > 12, image.psnr(pred, img)  # reading 14.3 dB
    # main() end to end: a small image file in, the render out
    src, out = str(tmp_path / "in.png"), str(tmp_path / "out.png")
    image.save_image(src, img[:16, :16])
    assert sample.main(["prog", src, str(sample.DEFAULT_CONFIG), "2", out, "cpu"]) == 0
    assert tuple(image.load_image(out).shape) == (16, 16, 3)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a GPU")
def test_sample_refuses_to_run_without_a_gpu():
    img = image.synthetic_image(8, 8, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample.train(REFERENCE_CONFIG, img, 1)


def test_native_pipeline_streams_tcnn_tpu_batches_and_trains_on_the_cpu():
    img = image.synthetic_image(64, 64, device="cpu")
    xy, rgb = next(sample.native_batches(img, 4096, torch.device("cpu")))
    want_xy, want_rgb = jax_native.HostRng(1337).image_batch(img.numpy(), 4096)
    np.testing.assert_array_equal(xy.numpy().view(np.int32), want_xy.view(np.int32))
    np.testing.assert_array_equal(rgb.numpy().view(np.int32), want_rgb.view(np.int32))
    cfg = tt.load_config(str(sample.DEFAULT_CONFIG))
    _, losses = sample.train(cfg, img, 20, device="cpu", batch=4096, log=None,
                             pipeline=sample.native_batches)
    assert losses.shape == (20,) and bool(torch.isfinite(losses).all())
    assert float(losses[0] / losses[-5:].mean()) > 5, losses


def pair(cfg, seed):
    """Both packages from one config; tcnn_tpu's params, the table redrawn
    from U(-1, 1), carried into the port."""
    jm = tc.create_from_config(2, 3, cfg)
    tm = tt.create_from_config(2, 3, cfg, seed=seed, device="cpu")
    p = np.asarray(jm.trainer.params).copy()
    n_net = jm.network.network.n_params
    p[n_net:] = np.random.default_rng(seed).uniform(-1, 1, p.size - n_net)
    jm.trainer.set_params(jnp.asarray(p))
    tm.trainer.set_params(tt.params_from_jax(p, tm.network.n_params))
    return jm, tm


def batch(seed, n=512):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n, 2)).astype(np.float32), rng.uniform(size=(n, 3)).astype(np.float32)


def check_same_step(jm, tm, x, t):
    """One step of each from the same params and Adam state: the loss, the
    moments and the step under the module docstring's bounds."""
    before = np.asarray(jm.trainer.params).copy()
    np.testing.assert_array_equal(tm.trainer.params.numpy(), before)
    jl = jm.trainer.training_step(jnp.asarray(x), jnp.asarray(t))
    tl = tm.trainer.training_step(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(float(tl), float(jl), rtol=2.0**-8)
    jo = {k: np.asarray(v) for k, v in jm.trainer.state["opt"].items()}
    for k in ("first_moments", "second_moments"):
        assert rel(tm.trainer.state["opt"][k], jo[k]) < 2.0**-5, (k, rel(tm.trainer.state["opt"][k], jo[k]))
    got, want = tm.trainer.params.numpy(), np.asarray(jm.trainer.params)
    moved = (got != before) | (want != before)
    off = (np.abs(got - want)[moved] > LR / 10).mean()
    assert off < STEP_OFF_MAX, off
    assert np.abs(got - before).max() > 0.5 * LR


def test_reference_default_composed_step_matches_jax_trainer():
    jm, tm = pair(REFERENCE_CONFIG, seed=3)
    assert tm.network.encoding._total_table_rows == 5_592_320
    assert jm.network.encoding._kernel_plan() is None  # tcnn_tpu's binned route on a TPU
    tm.trainer.use_fused_train_kernel = False
    check_same_step(jm, tm, *batch(4))


def test_port_snapshot_resumes_in_jax(tmp_path):
    """The reverse of tests/test_torch_train.py's test_jax_snapshot_resumes_
    in_port: the port trains two steps (K6's twin), saves with its
    optimizer block; tcnn_tpu's Trainer loads it, predicts the same and
    takes the same next step as the port."""
    cfg = json.loads(json.dumps(REFERENCE_CONFIG))
    cfg["encoding"].update(n_levels=3, base_resolution=2048)
    jm, tm = pair(cfg, seed=5)
    assert jm.network.encoding._kernel_plan() is None
    assert jm.network.encoding._binned_split().binned.n_levels == 3
    for s in range(2):
        tm.trainer.training_step(*map(torch.from_numpy, batch(10 + s)))
    path = str(tmp_path / "port.json")
    tm.trainer.save(path)
    jm.trainer.load(path)
    np.testing.assert_array_equal(np.asarray(jm.trainer.params), tm.trainer.params.numpy())
    for k, v in jm.trainer.state["opt"].items():
        np.testing.assert_array_equal(np.asarray(v), tm.trainer.state["opt"][k].numpy())
    xq = np.random.default_rng(12).uniform(size=(700, 2)).astype(np.float32)
    want = np.asarray(jm.trainer.inference(jnp.asarray(xq)), np.float32)
    got = tm.trainer.inference(torch.from_numpy(xq)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-5 * np.abs(want).max())
    tm.trainer.use_fused_train_kernel = False  # the route tcnn_tpu takes here
    check_same_step(jm, tm, *batch(13))
