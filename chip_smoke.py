#!/usr/bin/env python3
"""Drive the tcnn_tpu_torch inference path once on one CUDA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. environment: torch version, the card, `nvidia-smi` name and power limit;
  2. build: the kernels of tcnn_tpu_torch/csrc/ built with nvcc for sm_90a;
  3. each kernel (K1 grid forward, K2 fused MLP, K3 fused inference) against
     its plain PyTorch twin on the card at config_hash shapes, B = 2^18,
     2^18 - 37 and 1, and K2 also at width 128 with 5 hidden layers;
  4. the slice: `create_from_config` on data/config_hash.json at full
     width, requests through `trainer.inference` (K3) checked against the
     composed `model.apply` (K1 + K2) and against the plain twins on the CPU,
     the launch counters of that run, and a save/load round trip;
  5. times on the card (CUDA events) of each kernel and its twin at B = 2^18
     and of `trainer.inference` per call.
Then a line with every kernel, the `nvidia-smi` line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises, so the script exits
non-zero and prints no result; it also exits non-zero when no GPU is present.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 1234
B_MAIN = 1 << 18
BATCHES = (B_MAIN, B_MAIN - 37, 1)

#: K1 writes what its twin writes bit for bit when both round once per
#: operation; the check allows one bf16 ulp (2^-7 relative) per value.
K1_REL = 2.0**-7
#: K2/K3 sum each product in another order than torch's f32 matmul, which
#: can flip the bf16 rounding of a hidden unit; allowed: 2^-5 of the
#: output's largest magnitude (at least 2^-5 absolute).
MLP_REL = 2.0**-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def compare(name, got, want, rel_ulp=None, rel_max=None):
    import torch

    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype, f"{name}: shape/dtype")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    diff = (g - w).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if rel_ulp is not None:
        bound = rel_ulp * torch.maximum(g.abs(), w.abs())
        ok = bool((diff <= bound).all())
        limit = f"{rel_ulp} x |value|"
    else:
        limit = rel_max * max(1.0, float(w.abs().max()))
        ok = err <= limit
    emit({"phase": "compare", "name": name, "B": int(got.shape[0]), "max_abs_err": err,
          "bit_equal_share": float((diff == 0).float().mean()), "limit": str(limit), "ok": ok})
    check(ok, f"{name}: kernel disagrees with its plain twin (max abs err {err})")
    torch.cuda.synchronize()
    return err


def cuda_ms(fn, iters):
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_params(trainer, gen):
    """The model's init with the encoding table redrawn from U(-1, 1), so
    the MLP sees inputs of a trained model's size (the grid init is 1e-4)."""
    import torch

    p = trainer.params.detach().cpu().clone()
    n_net = trainer.model.network.n_params
    p[n_net:] = torch.rand(p.numel() - n_net, generator=gen) * 2 - 1
    return p


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.ops.cuda import _build, grid_kernel, mlp_kernel, train_kernel
    from tcnn_tpu_torch.common import Activation

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": card, "count": torch.cuda.device_count(), "nvidia_smi": smi})

    # 2. build
    t0 = time.perf_counter()
    lib = _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds, "library": lib._name,
          "flags": " ".join(_build.NVCC_FLAGS)})

    # 3. kernels against their plain twins at config_hash shapes
    cfg = tt.load_config(str(ROOT / "data" / "config_hash.json"))
    gen = torch.Generator().manual_seed(SEED)
    model = tt.create_from_config(2, 3, cfg, seed=SEED, device=dev)
    tr, net = model.trainer, model.network
    tr.set_params(random_params(tr, gen))
    prep = train_kernel.prepare_forward(net, tr.params)
    plan, dims = prep.plan, prep.dims
    enc_w = net.encoding.padded_output_width
    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    dims128 = mlp_kernel.MlpDims(enc_w, 128, 5, 16, Activation.ReLU, Activation.NONE)
    w128 = (torch.rand(dims128.n_weights, generator=gen) * 0.2 - 0.1).to(torch.bfloat16).to(dev)
    for B in BATCHES:
        x = torch.rand(B, 2, generator=gen).to(dev)
        enc_plain = grid_kernel._grid_encode_plain(plan, prep.table, x, enc_w, plan.n_levels)
        errs["K1"] = max(errs["K1"], compare(
            "K1 grid_fwd", grid_kernel.grid_encode(plan, prep.table, x, enc_w, plan.n_levels),
            enc_plain, rel_ulp=K1_REL))
        errs["K2"] = max(errs["K2"], compare(
            "K2 mlp_fwd", mlp_kernel.mlp_forward(dims, prep.weights, enc_plain),
            mlp_kernel._mlp_forward_plain(dims, prep.weights, enc_plain), rel_max=MLP_REL))
        errs["K2"] = max(errs["K2"], compare(
            "K2 mlp_fwd 128x5", mlp_kernel.mlp_forward(dims128, w128, enc_plain),
            mlp_kernel._mlp_forward_plain(dims128, w128, enc_plain), rel_max=MLP_REL))
        errs["K3"] = max(errs["K3"], compare(
            "K3 fused_infer", train_kernel.fused_forward_prepared(prep, x),
            train_kernel._fused_forward_plain(prep, x), rel_max=MLP_REL))
        torch.cuda.synchronize()

    # 4. the slice, through the entry points a user calls
    for mod in (grid_kernel, mlp_kernel, train_kernel):
        mod.LAUNCHES = 0
    model = tt.create_from_config(2, 3, tt.load_config(str(ROOT / "data" / "config_hash.json")),
                                  seed=SEED + 1, device="cuda")
    tr, net = model.trainer, model.network
    tr.set_params(random_params(tr, gen))
    requests = (B_MAIN, B_MAIN, B_MAIN, 100_003, 1)
    xs = [torch.rand(B, 2, generator=gen).to(dev) for B in requests]
    outs = []
    for x in xs:
        y = tr.inference(x)
        torch.cuda.synchronize()
        check(y.shape == (x.shape[0], 3) and y.dtype == torch.float32, "inference shape/dtype")
        check(bool(torch.isfinite(y).all()), "inference output not finite")
        outs.append(y)
    k3_launches = train_kernel.LAUNCHES
    composed = [net.apply(tr.params, x)[:, :3].float() for x in xs]
    torch.cuda.synchronize()
    for y, ref in zip(outs, composed):
        compare("slice inference vs model.apply", y, ref, rel_max=MLP_REL)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        path = os.path.join(tmp, "snapshot.json")
        tr.save(path)
        fresh = tt.create_from_config(2, 3, cfg, seed=SEED + 2, device="cuda")
        fresh.trainer.load(path)
        for x, y in zip(xs, outs):
            check(torch.equal(fresh.trainer.inference(x), y), "save/load changed predictions")
    launches = {"K1": grid_kernel.LAUNCHES, "K2": mlp_kernel.LAUNCHES, "K3": train_kernel.LAUNCHES}
    emit({"phase": "slice", "requests": list(requests), "launches": launches,
          "k3_launches_by_inference": k3_launches})
    check(k3_launches == len(requests), "trainer.inference did not run K3 once per request")
    check(launches["K1"] > 0 and launches["K2"] > 0, "model.apply did not run K1 and K2")

    # the plain twins on the CPU, on a small input, as an independent reference
    cpu = tt.create_from_config(2, 3, cfg, seed=SEED, device="cpu")
    cpu.trainer.set_params(tr.params.cpu())
    x_small = xs[3][:4096]
    compare("slice inference vs CPU plain twins", tr.inference(x_small).cpu(),
            cpu.trainer.inference(x_small.cpu()), rel_max=MLP_REL)

    # 5. times at B = 2^18
    x = xs[0]
    enc = net.encoding.apply(tr.params[net.network.n_params:], x)
    prep = train_kernel.prepare_forward(net, tr.params)
    timed = {
        "K1": (lambda: grid_kernel.grid_encode(plan, prep.table, x, enc_w, plan.n_levels),
               lambda: grid_kernel._grid_encode_plain(plan, prep.table, x, enc_w, plan.n_levels)),
        "K2": (lambda: mlp_kernel.mlp_forward(dims, prep.weights, enc),
               lambda: mlp_kernel._mlp_forward_plain(dims, prep.weights, enc)),
        "K3": (lambda: train_kernel.fused_forward_prepared(prep, x),
               lambda: train_kernel._fused_forward_plain(prep, x)),
    }
    ms = {}
    for name, (kern, plain) in timed.items():
        p1 = cuda_ms(plain, 5)
        k1 = cuda_ms(kern, 50)
        k2 = cuda_ms(kern, 50)
        p2 = cuda_ms(plain, 5)
        ms[name] = (min(k1, k2), min(p1, p2))
    infer_ms = cuda_ms(lambda: tr.inference(x), 50)
    emit({"phase": "times", "B": B_MAIN, "card": smi,
          "ms": {k: {"kernel": v[0], "plain": v[1]} for k, v in ms.items()},
          "trainer_inference_ms": infer_ms,
          "trainer_inference_Msamples_per_s": B_MAIN / infer_ms / 1e3})

    sources = {
        "K1": ("grid_fwd", "tcnn_tpu_torch/csrc/grid_fwd.cu",
               "tcnn_tpu/ops/pallas/grid_kernel.py:597"),
        "K2": ("mlp_fwd", "tcnn_tpu_torch/csrc/mlp_fwd.cu",
               "tcnn_tpu/ops/pallas/mlp_kernel.py:65"),
        "K3": ("fused_infer", "tcnn_tpu_torch/csrc/fused_infer.cu",
               "tcnn_tpu/ops/pallas/train_kernel.py:1412"),
    }
    emit({"kernels": [
        {"name": sources[k][0], "route": "cuda", "source": sources[k][1],
         "replaces": sources[k][2], "launches": launches[k], "max_abs_err": errs[k],
         "ms": ms[k][0], "plain_ms": ms[k][1]}
        for k in ("K1", "K2", "K3")
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
