"""The port's inference slice end to end on the CPU: both packages built
from one config dict, JAX params carried over, checkpoints read across,
and the package boundary (no JAX, no silent device).

Tolerances:
  - port `trainer.inference` vs JAX `fused_forward` (interpret mode): one
    bf16 ulp of the output's largest magnitude (2^-7 * max|y|), as in
    test_torch_fused.py;
  - port vs JAX's XLA route (`tcnn_tpu` Trainer.inference on the CPU, f32
    table): 2^-5 * max|y|. The port reads the table in bf16 (2^-9 relative
    per row) and each of the three layers rounds to bf16 at its own place;
    measured 0.0064 * max|y| at config_hash with a U(-1, 1) table, so the
    bound keeps a margin of about 5x.
"""

import json
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu.ops.pallas.train_kernel import fused_forward
from tcnn_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]

CONFIG = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    "encoding": {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
                 "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 1.5},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "None",
                "n_neurons": 64, "n_hidden_layers": 2},
}


def _pair(cfg=CONFIG, seed=0):
    """Both packages from one config; the JAX trainer's params (table redrawn
    from U(-1, 1)) carried into the port by params_from_jax."""
    jm = tc.create_from_config(2, 3, cfg)
    tm = tt.create_from_config(2, 3, cfg, device="cpu")
    p = np.asarray(jm.trainer.params).copy()
    n_net = jm.network.network.n_params
    p[n_net:] = np.random.default_rng(seed).uniform(-1, 1, p.size - n_net)
    jm.trainer.set_params(jnp.asarray(p))
    tm.trainer.set_params(tt.params_from_jax(np.asarray(jm.trainer.params), tm.network.n_params))
    return jm, tm


@pytest.mark.parametrize("batch", [700, 1, 333])
def test_inference_matches_jax_fused_forward(batch):
    jm, tm = _pair()
    x = np.random.default_rng(batch).uniform(0, 1, (batch, 2)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = fused_forward(jm.network, jm.trainer.params, jnp.asarray(x))
    want = np.asarray(want, np.float32)[:, :3]
    got = tm.trainer.inference(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (batch, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.0**-7 * np.abs(want).max())


def test_jax_snapshot_loads_into_port(tmp_path):
    jm, tm = _pair(seed=4)
    path = tmp_path / "snapshot.json"
    jm.trainer.save(str(path))  # includes the optimizer block
    fresh = tt.create_from_config(2, 3, CONFIG, seed=99, device="cpu")
    fresh.trainer.load(str(path))
    assert torch.equal(fresh.trainer.params, tm.trainer.params)
    x = torch.rand(257, 2)
    assert torch.equal(fresh.trainer.inference(x), tm.trainer.inference(x))
    # and the port's own snapshot reads back the same way
    tm.trainer.save(str(tmp_path / "port.json"))
    again = tt.create_from_config(2, 3, CONFIG, seed=5, device="cpu")
    again.trainer.load(str(tmp_path / "port.json"))
    assert torch.equal(again.trainer.inference(x), tm.trainer.inference(x))


def test_half_snapshot_loads():
    _, tm = _pair(seed=2)
    half = tm.trainer.params.numpy().astype(np.float16)
    snap = {"n_params": half.size, "params_type": "__half",
            "params_binary": list(half.tobytes())}
    tm.trainer.deserialize(json.loads(json.dumps(snap)))
    assert torch.equal(tm.trainer.params, torch.from_numpy(half.astype(np.float32)))
    with pytest.raises(ValueError, match="float or __half"):
        tm.trainer.deserialize({"params_type": "double", "params_binary": []})


def test_config_hash_full_width_matches_jax_xla_route():
    cfg_j = tc.load_config(str(ROOT / "data" / "config_hash.json"))
    cfg_t = tt.load_config(str(ROOT / "data" / "config_hash.json"))
    assert cfg_t == cfg_j
    jm, tm = _pair(cfg_j, seed=7)
    assert tm.network.n_params == jm.network.n_params == 715_760
    assert tm.network.layer_sizes() == jm.network.layer_sizes()
    assert tm.network.encoding.plan.total_rows == 354_296
    x = np.random.default_rng(8).uniform(0, 1, (256, 2)).astype(np.float32)
    want = np.asarray(jm.trainer.inference(jnp.asarray(x)))
    got = tm.trainer.inference(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-5 * np.abs(want).max())


def test_max_level_inference_takes_the_composed_path(monkeypatch):
    _, tm = _pair()

    def no_fused(*a, **k):
        raise AssertionError("max_level inference must not take the fused kernel")

    x = torch.rand(100, 2)
    full = tm.trainer.inference(x)
    tm.network.encoding.update_hyperparams({"max_level": 0.5})
    monkeypatch.setattr(tt.trainer, "fused_forward_prepared", no_fused)
    clamped = tm.trainer.inference(x)
    want = tm.network.apply(tm.trainer.params, x, max_level=0.5)[:, :3].float()
    assert torch.equal(clamped, want)
    assert not torch.equal(clamped, full)


def test_forward_and_unported_entry_points():
    _, tm = _pair()
    out = tm.trainer.forward(torch.rand(9, 2))["output"]
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (9, 16)
    loss = tm.trainer.training_step(torch.rand(9, 2), torch.rand(9, 3))
    assert loss.dim() == 0 and bool(torch.isfinite(loss))
    with pytest.raises(ValueError, match="targets or dL_doutput"):
        tm.trainer.training_step(torch.rand(9, 2))
    with pytest.raises(ValueError, match="not ported"):
        tt.create_encoding(2, {"otype": "NoSuchEncoding"})
    assert tt.create_encoding(2, {"otype": "Frequency"}).n_output_dims == 2 * 12 * 2
    with pytest.raises(ValueError, match="not ported"):
        tt.create_network(16, 3, {"otype": "NoSuchNet"})


def test_params_from_jax_checks_length_and_dtype():
    ok = np.zeros(10, np.float32)
    assert tt.params_from_jax(ok, 10).dtype == torch.float32
    with pytest.raises(ValueError, match="float32"):
        tt.params_from_jax(ok.astype(np.float64), 10)
    with pytest.raises(ValueError, match="11"):
        tt.params_from_jax(ok, 11)


def test_no_kernel_counter_moves_on_cpu():
    _, tm = _pair()
    before = profiling.counts("launches.")
    x = torch.rand(300, 2)
    tm.trainer.inference(x)
    tm.network.apply(tm.trainer.params, x)
    tm.trainer.forward(x)
    assert profiling.counts("launches.") == before


def test_cuda_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error cannot arise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.create_from_config(2, 3, CONFIG, device="cuda")
    # the port runs on the card unless the caller asks for the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.create_from_config(2, 3, CONFIG)


def test_package_source_never_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|tcnn_tpu)(\s|\.|$)", re.M)
    files = sorted((ROOT / "tcnn_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    for path in files:
        assert not pattern.search(path.read_text()), path


def test_import_and_inference_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch, tcnn_tpu_torch as tt\n"
        "m = tt.create_from_config(2, 3, tt.load_config('data/config_hash.json'), device='cpu')\n"
        "y = m.trainer.inference(torch.rand(129, 2))\n"
        "assert y.shape == (129, 3) and bool(torch.isfinite(y).all())\n"
        "assert 'tcnn_tpu' not in sys.modules and sys.modules['jax'] is None\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
