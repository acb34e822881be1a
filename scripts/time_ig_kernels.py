#!/usr/bin/env python3
"""Times of the input-gradient grid kernels K7 (``csrc/grid_bwd_ig.cu``)
and K8 (``csrc/grid_bwd_bwd.cu``) at the shapes the SDF sample gives them,
and of the HashGrid SDF step around them, on one CUDA GPU, through the
checkout's public wrappers:

    python3 scripts/time_ig_kernels.py [CHECKOUT] [--no-steps] [--ptxas]

CHECKOUT (default: the checkout holding this script) is the root of the
checkout whose `tcnn_tpu_torch` is built and timed, so the same file times
another commit's kernels, for example a parent commit unpacked with
`git archive`: run parent, this, this, parent in one call on one card and
compare within it. Each checkout builds its own library, of the sources
the SDF step runs (the grid and MLP kernels, K3 and K9; not K6 or the
PPNG kernels), or of the grid sources alone with --no-steps.

Shapes, all at the SDF sample's HashGrid (samples/learn_a_sdf.py: 3-D, 12
levels, F = 2, base 8, scale 1.5), the table redrawn from U(-1, 1) and the
cotangents those the eikonal step gives (chip_smoke.eikonal_inputs): the
eikonal term's 1024 points at T = 2^17 and T = 2^19, B = 2^16, 2^17 and
2^18 at T = 2^17, and "hot": B = 2^16 - 37 samples at one point (0.5, 0, 1).
Each kernel: K7 (`grid_backward_ig`), K8 without a table cotangent (the
eikonal step's call) and with one; each output held
against its plain twin (norm-relative). Timed with CUDA events (50
launches, best of two turns; the wrapper's call, its outputs' zeroing
included) and under torch.profiler for each call's device time by kernel
(10 launches), which splits a call into the kernel's own time and its
wrapper's memsets. Beside them the library yardstick: one `index_add_` of
the kernel's bf16-rounded table contributions, rows and contributions
computed beforehand, into a zeroed f32 gradient (as chip_smoke.py's
k4_yardstick times K4's).

Unless --no-steps, the SDF sample's `train_step` at B = 2^16 (1024
eikonal points) at T = 2^17 and T = 2^19: wall ms a step (host clock
around synchronised steps), and under torch.profiler the device ms a
step, launches a step, the device's busy share and the device ms a step
of each kernel name (K7, K8, the memsets and fills, the elementwise adds
that accumulate gradients among them). With --ptxas, `nvcc -Xptxas -v` of
the checkout's grid_bwd_ig.cu and grid_bwd_bwd.cu: registers, shared
memory and spills. Prints one JSON line with the card's `nvidia-smi`
name and power limit. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

SEED = 1234
ITERS = 50
#: The sources the SDF step runs (K1-K5, K7-K9), and the grid sources alone.
STEP_SOURCES = ("grid_fwd.cu", "grid_bwd.cu", "grid_bwd_ig.cu", "grid_bwd_bwd.cu", "mlp_fwd.cu",
                "mlp_bwd.cu", "fused_infer.cu", "fused_ig.cu", "fused_ig_f1.cu", "fused_ig_f2.cu",
                "fused_ig_f4.cu", "fused_ig_f8.cu")
GRID_SOURCES = ("grid_fwd.cu", "grid_bwd_ig.cu", "grid_bwd_bwd.cu")
HOT_POINT = (0.5, 0.0, 1.0)
#: (label, log2 T, B, point or None)
CASES = (("1024 T=2^17", 17, 1024, None), ("1024 T=2^19", 19, 1024, None),
         ("2^16", 17, 1 << 16, None), ("2^17", 17, 1 << 17, None), ("2^18", 17, 1 << 18, None),
         ("hot 2^16-37", 17, (1 << 16) - 37, HOT_POINT))


def checkout_root(args) -> pathlib.Path:
    """The checkout named by the first argument that is not an option (this
    script's own by default), put first on sys.path."""
    rest = [a for a in args if not a.startswith("--")]
    root = pathlib.Path(rest[0] if rest else __file__).resolve()
    if root.is_file():
        root = root.parents[1]
    sys.path.insert(0, str(root))
    return root


def use_sources(names) -> None:
    """Build the library from the named sources of the checkout only."""
    from tcnn_tpu_torch.ops.cuda import _build

    cu, cuh = _build._sources()
    _build._sources = lambda: ([p for p in cu if p.name in names], cuh)


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=ITERS, turns=2):
    """Best of `turns` turns of `iters` launches, ms a launch (CUDA events)."""
    import torch

    for _ in range(3):
        fn()
    best = None
    for _ in range(turns):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        best = ms if best is None else min(best, ms)
    return best


def device_ms(fn, iters=10):
    """(device ms a call: the sum of its CUDA kernels' and memsets' times
    under torch.profiler, {kernel name: ms a call})"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if t > 0:
            by_name[ev.key[:60]] = t / 1e3 / iters
    return sum(by_name.values()), by_name


def norm_rel(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30))


def sdf_model(log2_t: int, dev, gen, seed=SEED):
    """The SDF sample's HashGrid model at T = 2^log2_t with its table
    redrawn from U(-1, 1) (chip_smoke.random_params)."""
    import tcnn_tpu_torch as tt
    from chip_smoke import random_params
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    cfg = sdf.config("HashGrid")
    cfg["encoding"]["log2_hashmap_size"] = log2_t
    m = tt.create_from_config(3, 1, cfg, seed=seed, device=dev)
    m.trainer.set_params(random_params(m.trainer, gen).to(dev))
    return m


def case_inputs(dev, gen):
    """{label: (plan, table, x, gy_enc, z, ct_table)} of CASES, on `dev`."""
    import torch
    from chip_smoke import eikonal_inputs

    models, out = {}, {}
    for label, log2_t, B, point in CASES:
        if log2_t not in models:
            models[log2_t] = sdf_model(log2_t, dev, gen)
        net, params = models[log2_t].network, models[log2_t].trainer.params
        plan = net.encoding.plan
        if point is None:
            x = torch.rand(B, 3, generator=gen).to(dev)
        else:
            x = torch.tensor(point, dtype=torch.float32).expand(B, 3).contiguous().to(dev)
        table, _, gy_enc, z = eikonal_inputs(net, params, x)
        ct = (torch.randn(plan.total_rows, plan.f, generator=gen) * 1e-2).to(torch.bfloat16).to(dev)
        out[label] = (plan, table, x, gy_enc, z, ct)
    return out


def yardsticks(plan, x, gy_enc, z):
    """{K7, K8: callable}: one `index_add_` of the kernel's bf16-rounded
    table contributions (K7: W_c gy, K8: zw_c gy, zw_c = sum_d z_d
    dW_c/dx_d) into a zeroed f32 gradient, rows and contributions computed
    beforehand."""
    import torch
    from tcnn_tpu_torch.ops.cuda import grid_kernel

    L, F = plan.n_levels, plan.f
    g = gy_enc[:, : L * F].float().reshape(-1, L, F)
    rows, c7, c8 = [], [], []
    for k in grid_kernel._corners(plan, x, derivs=True):
        rows.append(k.rows.reshape(-1))
        c7.append((k.w[..., None] * g).to(torch.bfloat16).float().reshape(-1, F))
        zw = sum(z[:, None, d] * k.dw[d] for d in range(plan.d))
        c8.append((zw[..., None] * g).to(torch.bfloat16).float().reshape(-1, F))
    rows, c7, c8 = torch.cat(rows), torch.cat(c7), torch.cat(c8)
    out = torch.zeros((plan.total_rows, F), dtype=torch.float32, device=x.device)
    return {"K7": lambda: out.zero_().index_add_(0, rows, c7),
            "K8": lambda: out.zero_().index_add_(0, rows, c8)}


def kernel_calls(plan, table, x, gy_enc, z, ct):
    """{name: (kernel call, twin call)} of K7 and K8 on these inputs."""
    from tcnn_tpu_torch.ops.cuda import grid_kernel as gk

    return {
        "K7": (lambda: gk.grid_backward_ig(plan, table, x, gy_enc),
               lambda: gk._grid_backward_ig_plain(plan, table, x, gy_enc)),
        "K8": (lambda: gk.grid_backward_bwd(plan, table, None, x, gy_enc, z),
               lambda: gk._grid_backward_bwd_plain(plan, table, None, x, gy_enc, z)),
        "K8 ct_table": (lambda: gk.grid_backward_bwd(plan, table, ct, x, gy_enc, z),
                        lambda: gk._grid_backward_bwd_plain(plan, table, ct, x, gy_enc, z)),
    }


def errors(got, want) -> list:
    return [None if w is None else norm_rel(g, w) for g, w in zip(got, want)]


def step_profile(log2_t, dev, gen, warmup=10, steps=20):
    """The SDF sample's train_step at T = 2^log2_t: wall ms, device ms,
    launches and busy share a step, and device ms a step by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    m = sdf_model(log2_t, dev, gen, seed=SEED + log2_t)
    xs = torch.rand(sdf.BATCH, 3, generator=gen).to(dev)
    step = lambda: sdf.train_step(m.trainer, xs)  # noqa: E731
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / steps
    kernels, launches = {}, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time_total > 0:
            key = ev.name[:80]
            kernels[key] = kernels.get(key, 0.0) + ev.device_time_total / 1e3 / steps
            launches += 1
    dev_ms = sum(kernels.values())
    return {"wall_ms": wall, "profiled_wall_ms": prof_wall, "device_ms": dev_ms,
            "device_busy": dev_ms / prof_wall, "launches_per_step": launches / steps,
            "kernels_ms_per_step": dict(sorted(kernels.items(), key=lambda kv: -kv[1]))}


def ptxas_readings():
    """{kernel: ptxas's 'Used ...' and spill lines} of grid_bwd_ig.cu and
    grid_bwd_bwd.cu."""
    from tcnn_tpu_torch.ops.cuda import _build

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in ("grid_bwd_ig.cu", "grid_bwd_bwd.cu"):
            text = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                                   "-o", f"{tmp}/{src}.o", str(_build.CSRC / src)],
                                  capture_output=True, text=True, check=True).stderr
            name = None
            for line in text.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    name = m.group(1)
                elif name and ("Used" in line or "spill" in line):
                    out.setdefault(name, []).append(line.split("info    :")[-1].strip())
    return out


def main(argv) -> int:
    root = checkout_root(argv[1:])
    import torch

    if not torch.cuda.is_available():
        print("time_ig_kernels: no CUDA device available", file=sys.stderr)
        return 1
    from tcnn_tpu_torch.ops.cuda import _build

    steps = "--no-steps" not in argv
    use_sources(STEP_SOURCES if steps else GRID_SOURCES)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card_name()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    _build.library()
    ms, dev_ms, err, lib_ms = {}, {}, {}, {}
    inputs = case_inputs(dev, gen)
    for label, (plan, table, x, gy_enc, z, ct) in inputs.items():
        for name, (kern, twin) in kernel_calls(plan, table, x, gy_enc, z, ct).items():
            key = f"{name} {label}"
            err[key] = errors(kern(), twin())
            ms[key] = cuda_ms(kern)
            dev_ms[key] = device_ms(kern)
        for name, fn in yardsticks(plan, x, gy_enc, z).items():
            lib_ms[f"{name} {label}"] = cuda_ms(fn)
    profiles = {f"T=2^{t}": step_profile(t, dev, gen) for t in (17, 19)} if steps else None
    print(json.dumps({"checkout": str(root), "card": smi, "ms": ms, "device_ms": dev_ms,
                      "err": err, "library_ms": lib_ms, "steps": profiles,
                      "build_s": _build.build_seconds,
                      "ptxas": ptxas_readings() if "--ptxas" in argv else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
