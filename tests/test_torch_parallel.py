"""The port's data parallelism (tcnn_tpu_torch/parallel/) on 2 ranks against
tcnn_tpu's on 2 devices, on the CPU.

One spawn of 2 port-only rank processes (gloo on the CPU, one torch thread
each, a file rendezvous under tmp_path) runs every case; meanwhile the test
process runs tcnn_tpu's `shard_map` over 2 of conftest's 8 virtual devices
and the port's single-process references on the same numpy inputs and
params. Checked:
  - the reduced loss and gradient (RelativeL2, Variance and CrossEntropy
    with a pdf) against tcnn_tpu's pmean, as tests/test_parallel.py:296-337
    holds tcnn_tpu's own;
  - EMA(Adam) and Shampoo trajectories of `DataParallelTrainer.step`
    against tcnn_tpu's `DataParallelTrainer`;
  - `external_grad`'s sum over the ranks against tcnn_tpu's psum, and a
    `step_external`;
  - the fused route's step (K6's twin) against the port's own
    single-process step at the global batch;
  - both ranks' params and losses bit-equal after every case;
  - `init_distributed`'s single-process no-op, `shard_batch`'s row blocks,
    `host_shard_key`'s streams and the noise generators, per rank;
  - `dryrun_multichip(2, "cpu")`, its ranks spawned apart from that spawn.

Tolerances. The ranks take the composed route where they are held against
tcnn_tpu, whose Trainer takes its XLA composed route off a TPU: the port's
reads the table in bf16 and rounds each table contribution to bf16 where
tcnn_tpu's keeps f32, so the bounds are those of
tests/test_torch_optimizers.py's composed-route trajectory (losses within
1e-3 relative, params and EMA weights within 1e-2 norm-relative) and of
tests/test_torch_train.py for a gradient against another precision
(norm-relative 2^-6, as K6's twin against the composed route). Readings:
reduced gradients 8.4e-3 to 9.7e-3, the external sum 9.2e-3, trajectories'
params 1.5e-3 (EMA(Adam); its EMA weights 7.6e-4) and 6.6e-3 (Shampoo),
losses within 4e-5. Against the port's own single-process step the sums
differ only in order: the gradient within 2e-5 of its largest entry
(tests/test_parallel.py's bound for tcnn_tpu; readings below 1e-7), the
loss within 1e-5 relative. The model is tests/test_torch_optimizers.py's
composed-route one (4 levels, T = 2^10, 16 x 1), its output through
Sigmoid for the losses.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu.parallel.data_parallel import DataParallelTrainer as JaxDataParallelTrainer
from tcnn_tpu.parallel.data_parallel import create_mesh as jax_create_mesh
from tcnn_tpu_torch.parallel import dryrun_multichip, host_shard_key, init_distributed
from tcnn_tpu_torch.parallel.data_parallel import DRYRUN_CONFIGS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 512
N_STEPS = 5
N_FUSED_STEPS = 3
LOSS_RTOL = 1e-3
PARAM_REL = 1e-2
GRAD_REL = 2.0**-6
SAME_ROUTE_GRAD_ATOL = 2e-5
SAME_ROUTE_LOSS_RTOL = 1e-5

ADAM = {"otype": "Adam", "learning_rate": 1e-2}
CFG = {
    "loss": {"otype": "L2"},
    "optimizer": ADAM,
    "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                 "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 1.6},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 16, "n_hidden_layers": 1},
}
#: The losses' model: its output through Sigmoid, so that Variance's 1/p
#: and CrossEntropy's log p see predictions in (0, 1).
LOSS_NETWORK = {**CFG["network"], "output_activation": "Sigmoid"}
LOSSES = ("RelativeL2", "Variance", "CrossEntropy")
OPTIMIZERS = {"EMA(Adam)": {"otype": "EMA", "decay": 0.95, "nested": ADAM},
              "Shampoo": {"otype": "Shampoo", "learning_rate": 1e-2}}

#: One rank: every case on the inputs of inputs.npz; writes rank<r>.npz.
_RANK = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.modules["jax"] = None  # the ranks run the port alone
import tcnn_tpu_torch as tt
from tcnn_tpu_torch.parallel import (DataParallelTrainer, create_mesh, global_mesh,
                                     host_shard_key, init_distributed)

rank, tmp = int(sys.argv[1]), sys.argv[2]
cases = json.loads(sys.argv[3])
inp = dict(np.load(f"{tmp}/inputs.npz"))
got = init_distributed(f"file://{tmp}/rendezvous", 2, rank, backend="gloo")
out = {"init": np.array([*got, *init_distributed()])}

def model(cfg, key, route_fused):
    m = tt.create_from_config(2, 3, cfg, device="cpu")
    m.trainer.set_params(torch.from_numpy(inp[f"params {key}"]))
    m.trainer.use_fused_train_kernel = route_fused
    return m.trainer

T = lambda k: torch.from_numpy(inp[k])
tr = model(cases["base"], "base", False)
dp = DataParallelTrainer(tr, global_mesh())
out["noise seed"] = np.array([tr.noise_generator.initial_seed()], np.uint64)
(out["rows"],) = dp.shard_batch(torch.arange(12.0).reshape(6, 2))
try:
    dp.shard_batch(torch.zeros(7, 2))
    out["odd batch raises"] = np.array([0])
except ValueError:
    out["odd batch raises"] = np.array([1])
for s in range(2):
    out[f"key {s}"] = torch.rand(8, generator=host_shard_key(7, s, device="cpu"))
out["key 0 again"] = torch.rand(8, generator=host_shard_key(7, 0, device="cpu"))

for otype in cases["losses"]:
    tr = model(cases["loss " + otype], otype, False)
    dp = DataParallelTrainer(tr, create_mesh())
    loss, grads = dp.loss_and_grad(tr.params, T("x"), T("t pos"), T("pdf"))
    out[f"loss {otype}"], out[f"grad {otype}"] = loss.reshape(1), grads

for name in cases["optimizers"]:
    tr = model(cases["opt " + name], name, False)
    dp = DataParallelTrainer(tr, create_mesh())
    state = dp.replicate(tr.state)
    losses = [dp.step(state, T(f"x {i}"), T(f"t {i}"))[1] for i in range(cases["steps"])]
    out[f"losses {name}"] = torch.stack(losses)
    out[f"params {name}"] = state["params"]
    out[f"inference params {name}"] = tr.inference_params

tr = model(cases["base"], "base", False)
dp = DataParallelTrainer(tr, create_mesh())
state = dp.replicate(tr.state)
out["external grad"] = dp.external_grad(tr.params, T("x"), T("dl"))
dp.step_external(state, T("x"), T("dl"))
out["params external"] = state["params"]

tr = model(cases["base"], "base", True)
assert tr.use_fused()
dp = DataParallelTrainer(tr, create_mesh())
state = dp.replicate(tr.state)
losses = [dp.step(state, T(f"x {i}"), T(f"t {i}"))[1] for i in range(cases["fused_steps"])]
out["losses fused"], out["params fused"] = torch.stack(losses), state["params"]
np.savez(f"{tmp}/rank{rank}.npz", **{k: np.asarray(v) for k, v in out.items()})
"""


def _cfg(**kw):
    return json.loads(json.dumps({**CFG, **kw}))


def _target(x):
    return np.stack([np.sin(5 * x[:, 0]) * 0.5 + 0.5, x[:, 1], x[:, 0] * x[:, 1]], -1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _jax_model(cfg):
    return tc.create_from_config(2, 3, cfg)


def _port_trainer(cfg, params, fused):
    m = tt.create_from_config(2, 3, cfg, device="cpu")
    m.trainer.set_params(tt.params_from_jax(params, m.network.n_params))
    m.trainer.use_fused_train_kernel = fused
    return m.trainer


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' outputs by rank, tcnn_tpu's results, the port's
    single-process results, the inputs)."""
    tmp = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(0)
    inp = {"x": rng.uniform(size=(B, 2)).astype(np.float32),
           "pdf": (rng.uniform(size=(B, 3)) + 0.5).astype(np.float32),
           "dl": np.zeros((B, 16), np.float32)}
    inp["t pos"] = (np.abs(_target(inp["x"])) + 0.05).astype(np.float32)
    # an L2 loss's dL/doutput at a zero prediction, on the 3 outputs and not the padding
    inp["dl"][:, :3] = -2.0 * inp["t pos"] / (3 * B)
    for i in range(N_STEPS):
        inp[f"x {i}"] = rng.uniform(size=(B, 2)).astype(np.float32)
        inp[f"t {i}"] = _target(inp[f"x {i}"]).astype(np.float32)
    cases = {"losses": LOSSES, "optimizers": list(OPTIMIZERS), "steps": N_STEPS,
             "fused_steps": N_FUSED_STEPS, "base": CFG}
    jms = {"base": _jax_model(CFG)}
    for otype in LOSSES:
        cases["loss " + otype] = _cfg(loss={"otype": otype}, network=LOSS_NETWORK)
        jms[otype] = _jax_model(cases["loss " + otype])
    for name, opt in OPTIMIZERS.items():
        cases["opt " + name] = _cfg(optimizer=opt)
        jms[name] = _jax_model(cases["opt " + name])
    for key, jm in jms.items():
        inp[f"params {key}"] = np.asarray(jm.trainer.params).copy()
    np.savez(tmp / "inputs.npz", **inp)

    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(tmp), json.dumps(cases)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(2)]
    try:
        jax_out = _jax_results(jms, inp)
        port_out = _port_results(cases, inp)
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return ranks, jax_out, port_out, inp


def _jax_results(jms, inp):
    """tcnn_tpu on a 2-device mesh: pmean'd loss and gradient per loss,
    psum'd external gradient, and DataParallelTrainer trajectories."""
    devices = jax.devices()[:2]
    mesh = jax_create_mesh(devices)
    key = jax.random.PRNGKey(0)
    x, t, pdf = (jnp.asarray(inp[k]) for k in ("x", "t pos", "pdf"))
    out = {}
    for otype in LOSSES:
        tr = jms[otype].trainer

        def shard_fn(params, xx, tt_, pp, tr=tr):
            lv, g = tr.loss_and_grad_fn(params, xx, tt_, pp, key)
            return jax.lax.pmean(lv, "data"), jax.lax.pmean(g, "data")

        lv, g = jax.jit(jax.shard_map(shard_fn, mesh=mesh,
                                      in_specs=(P(), P("data"), P("data"), P("data")),
                                      out_specs=(P(), P()), check_vma=False))(tr.params, x, t, pdf)
        out[f"loss {otype}"], out[f"grad {otype}"] = float(lv), np.asarray(g)

    tr = jms["base"].trainer
    ext = jax.jit(jax.shard_map(
        lambda params, xx, dl: jax.lax.psum(tr.external_grad_fn(params, xx, dl), "data"),
        mesh=mesh, in_specs=(P(), P("data"), P("data")), out_specs=P(),
        check_vma=False))(tr.params, x, jnp.asarray(inp["dl"]))
    out["external grad"] = np.asarray(ext)

    for name in OPTIMIZERS:
        tr = jms[name].trainer
        dp = JaxDataParallelTrainer(tr, mesh)
        state = dp.replicate(tr.state)
        losses = []
        for i in range(N_STEPS):
            state, lv = dp.step(state, jnp.asarray(inp[f"x {i}"]), jnp.asarray(inp[f"t {i}"]))
            losses.append(float(lv))
        out[f"losses {name}"] = np.asarray(losses)
        out[f"params {name}"] = np.asarray(state["params"])
        cw = tr.optimizer.custom_weights(state["opt"], state["params"])
        out[f"inference params {name}"] = np.asarray(state["params"] if cw is None else cw)
    return out


def _port_results(cases, inp):
    """The port in this process at the global batch: the fused route's
    steps and each loss's gradient on both routes."""
    T = lambda k: torch.from_numpy(inp[k])  # noqa: E731
    out = {}
    for otype in LOSSES:
        tr = _port_trainer(cases["loss " + otype], inp[f"params {otype}"], False)
        out[f"loss {otype}"], out[f"grad {otype}"] = tr.loss_and_grad_fn(
            tr.params, T("x"), T("t pos"), T("pdf"))
    tr = _port_trainer(CFG, inp["params base"], False)
    out["external grad"] = tr.external_grad_fn(tr.params, T("x"), T("dl"))
    tr = _port_trainer(CFG, inp["params base"], True)
    out["losses fused"] = torch.stack([tr.training_step(T(f"x {i}"), T(f"t {i}"))
                                       for i in range(N_FUSED_STEPS)])
    out["params fused"] = tr.params
    return {k: np.asarray(v) for k, v in out.items()}


def test_ranks_bit_equal(runs):
    ranks = runs[0]
    shared = [k for k in ranks[0] if k.startswith(("params", "inference params", "losses",
                                                   "loss ", "grad", "external"))]
    assert len(shared) == 16
    for k in shared:
        np.testing.assert_array_equal(ranks[0][k].view(np.uint8), ranks[1][k].view(np.uint8), k)


@pytest.mark.parametrize("otype", LOSSES)
def test_reduced_loss_and_gradient_match_jax_pmean(runs, otype):
    ranks, jax_out, port_out, _ = runs
    got_l, got_g = float(ranks[0][f"loss {otype}"][0]), ranks[0][f"grad {otype}"]
    assert got_l == pytest.approx(jax_out[f"loss {otype}"], rel=LOSS_RTOL)
    assert _rel(got_g, jax_out[f"grad {otype}"]) < GRAD_REL, _rel(got_g, jax_out[f"grad {otype}"])
    # against the port's own gradient at the global batch: the sum's order alone
    want_g = port_out[f"grad {otype}"]
    assert got_l == pytest.approx(float(port_out[f"loss {otype}"]), rel=SAME_ROUTE_LOSS_RTOL)
    np.testing.assert_allclose(got_g / np.abs(want_g).max(), want_g / np.abs(want_g).max(),
                               rtol=0, atol=SAME_ROUTE_GRAD_ATOL)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_trajectory_matches_jax_data_parallel(runs, name):
    ranks, jax_out, _, _ = runs
    np.testing.assert_allclose(ranks[0][f"losses {name}"], jax_out[f"losses {name}"],
                               rtol=LOSS_RTOL)
    for k in (f"params {name}", f"inference params {name}"):
        assert _rel(ranks[0][k], jax_out[k]) < PARAM_REL, (k, _rel(ranks[0][k], jax_out[k]))


def test_external_gradient_is_the_sum_over_ranks(runs):
    ranks, jax_out, port_out, inp = runs
    got = ranks[0]["external grad"]
    assert _rel(got, jax_out["external grad"]) < GRAD_REL
    want = port_out["external grad"]
    np.testing.assert_allclose(got / np.abs(want).max(), want / np.abs(want).max(), rtol=0,
                               atol=SAME_ROUTE_GRAD_ATOL)
    assert not np.array_equal(ranks[0]["params external"], inp["params base"])


def test_fused_route_steps_match_single_process(runs):
    """K6's twin on each rank's shard, then the all-reduce: after the first
    step the params agree to f32 summation order; later steps compare the
    losses (Adam's first steps are about lr * sign(g), which turns a
    rounding near g = 0 into a step of lr: tests/test_parallel.py)."""
    ranks, _, port_out, _ = runs
    np.testing.assert_allclose(ranks[0]["losses fused"], port_out["losses fused"],
                               rtol=LOSS_RTOL)
    assert ranks[0]["losses fused"][-1] < ranks[0]["losses fused"][0]
    assert _rel(ranks[0]["params fused"], port_out["params fused"]) < PARAM_REL


def test_shard_batch_takes_each_ranks_row_block(runs):
    ranks = runs[0]
    rows = np.arange(12.0, dtype=np.float32).reshape(6, 2)
    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["rows"], rows[3 * r:3 * r + 3])
        assert ranks[r]["odd batch raises"][0] == 1


def test_init_and_keys_per_rank(runs):
    ranks = runs[0]
    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["init"], [r, 2, r, 2])  # the second call: no-op
        np.testing.assert_array_equal(ranks[r]["key 0"], ranks[r]["key 0 again"])
        assert not np.array_equal(ranks[r]["key 0"], ranks[r]["key 1"])
    assert not np.array_equal(ranks[0]["key 0"], ranks[1]["key 0"])
    assert ranks[0]["noise seed"][0] != ranks[1]["noise seed"][0]


def test_single_process_init_is_a_no_op(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() == (0, 1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(num_processes=2)
    # alone, the generator folds rank 0: deterministic, and another stream per step
    a = torch.rand(4, generator=host_shard_key(3, 1, device="cpu"))
    assert torch.equal(a, torch.rand(4, generator=host_shard_key(3, 1, device="cpu")))
    assert not torch.equal(a, torch.rand(4, generator=host_shard_key(3, 2, device="cpu")))


def test_dryrun_multichip_on_the_cpu(monkeypatch, capsys):
    """The port's dry run: 2 spawned gloo ranks train config_hash under
    EMA(Adam) and PPNG3 a few steps, the ranks' losses equal and falling."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # each spawned rank's torch threads
    outs = dryrun_multichip(2, device="cpu")
    assert len(outs) == 2
    lines = capsys.readouterr().out.splitlines()
    assert sum(": ok; loss" in line for line in lines) == len(DRYRUN_CONFIGS), lines
