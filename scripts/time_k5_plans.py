"""K5's two plans on one CUDA GPU: the resident kernel (csrc/mlp_bwd.cu) and
the split plan (csrc/mlp_bwd_split.cu: dgrad, split-K weight gradient,
fixed-order reduce), each against the plain twin and timed at the shapes
that reach K5:

    python3 scripts/time_k5_plans.py [--ptxas] [--no-check]

Shapes: config_oneblob's MLP (input 128, 128 x 5, 16 out) and the same MLP
at input 32, B = 2^18; NeRF's density (32 -> 64 -> 16) and colour (32 ->
64 x 2 -> 16) MLPs at 2^21 rows, the size of the NeRF cell's step. Each
shape runs both plans (the wrapper picks one by `mlp_bwd_plan`; this script
calls each plan's launcher directly), random bf16 weights U(-0.1, 0.1),
inputs U(-1, 1) and a normal cotangent from one seed.

Check (unless --no-check): each plan against `_mlp_backward_plain` at B =
2^18, 2^18 - 37 and 1 (norm-relative gW and gx), and gW and gx bit-equal
between two launches. Times: CUDA events (20 launches a turn, best of two)
and torch.profiler's device time by kernel (10 launches), beside the bound
(`k5_bound`: x, gy and the weights read once, gW in f32 and dL/dinput
written once, 6 B n_weights bf16 FLOPs; H100: 3.35 TB/s, 989 TFLOP/s).
With --ptxas, also `nvcc -Xptxas -v` of mlp_bwd.cu and mlp_bwd_split.cu.
Builds a library of the MLP kernels' sources only (and grid_fwd.cu, which
holds the error strings).
Prints one JSON line per reading; the last holds the card's `nvidia-smi`
name and power limit. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SEED = 1234
SOURCES = ("grid_fwd.cu", "mlp_fwd.cu", "mlp_bwd.cu", "mlp_bwd_split.cu")
ITERS = 20
B_MAIN = 1 << 18
#: (name, in_w, width, n_hidden, out_w, rows)
SHAPES = (("oneblob 128x5 in128", 128, 128, 5, 16, B_MAIN),
          ("128x5 in32", 32, 128, 5, 16, B_MAIN),
          ("nerf density 32-64x1-16", 32, 64, 1, 16, 1 << 21),
          ("nerf colour 32-64x2-16", 32, 64, 2, 16, 1 << 21))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn):
    import torch

    for _ in range(2):
        fn()
    best = None
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / ITERS
        best = ms if best is None else min(best, ms)
    return best


def device_ms(fn, iters=10):
    """(device ms a call, {kernel name: device ms a call}) under torch.profiler."""
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
        t = ev.self_cuda_time_total if t is None else t
        if t > 0:
            by_name[ev.key[:70]] = t / 1e3 / iters
    return sum(by_name.values()), by_name


def k5_bound(dims, B):
    """K5's (bound ms, bound_by), as chip_smoke.py's k5_bound counts it."""
    n_bytes = 2 * B * (dims.in_w + dims.out_w) + 2 * dims.n_weights + 4 * dims.n_weights \
        + 2 * B * dims.in_w
    mem, ops = n_bytes / 3.35e12 * 1e3, 6 * B * dims.n_weights / 989e12 * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def rel(got, want):
    import torch

    d = torch.linalg.vector_norm(got.double() - want.double())
    return float(d / torch.linalg.vector_norm(want.double()).clamp_min(1e-30))


def ptxas():
    from tcnn_tpu_torch.ops.cuda import _build

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in ("mlp_bwd.cu", "mlp_bwd_split.cu"):
            text = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                                   "-o", f"{tmp}/{src}.o", str(_build.CSRC / src)],
                                  capture_output=True, text=True).stderr
            name = None
            for line in text.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    name = m.group(1)
                elif name and ("Used" in line or "spill" in line):
                    out.setdefault(name, []).append(line.split("info    :")[-1].strip())
    emit({"phase": "ptxas", "kernels": out})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_k5_plans: no CUDA device", file=sys.stderr)
        return 1
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.cuda import _build, mlp_kernel as mk

    torch.backends.cuda.matmul.allow_tf32 = False
    cu, cuh = _build._sources()
    _build._sources = lambda: ([p for p in cu if p.name in SOURCES], cuh)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    _build.library()
    if "--ptxas" in sys.argv:
        ptxas()
    plans = {"resident": mk._mlp_backward_resident, "split": mk._mlp_backward_split}
    gen = torch.Generator().manual_seed(SEED)
    for name, in_w, width, n_hidden, out_w, rows in SHAPES:
        dims = mk.MlpDims(in_w, width, n_hidden, out_w, Activation.ReLU, Activation.NONE)
        w = (torch.rand(dims.n_weights, generator=gen) * 0.2 - 0.1).to(torch.bfloat16).to(dev)
        if "--no-check" not in sys.argv and rows == B_MAIN:
            for B in (B_MAIN, B_MAIN - 37, 1):
                x = (torch.rand(B, in_w, generator=gen) * 2 - 1).to(torch.bfloat16).to(dev)
                gy = torch.randn(B, out_w, generator=gen).to(torch.bfloat16).to(dev)
                pw, px = mk._mlp_backward_plain(dims, w, x, gy)
                for plan, fn in plans.items():
                    gw, gx = fn(dims, w, x, gy, B)
                    gw2, gx2 = fn(dims, w, x, gy, B)
                    torch.cuda.synchronize()
                    emit({"phase": "check", "shape": name, "plan": plan, "B": B,
                          "gW_rel": rel(gw, pw), "gx_rel": rel(gx.float(), px.float()),
                          "bit_equal": bool(torch.equal(gw, gw2) and torch.equal(gx, gx2)),
                          "finite": bool(torch.isfinite(gw).all() and torch.isfinite(gx).all())})
        x = (torch.rand(rows, in_w, generator=gen) * 2 - 1).to(torch.bfloat16).to(dev)
        gy = torch.randn(rows, out_w, generator=gen).to(torch.bfloat16).to(dev)
        bound = k5_bound(dims, rows)
        for plan, fn in plans.items():
            call = lambda: fn(dims, w, x, gy, rows)  # noqa: E731
            torch.cuda.reset_peak_memory_stats(dev)
            ms = cuda_ms(call)
            total, by_name = device_ms(call)
            emit({"phase": "time", "shape": name, "plan": plan, "B": rows,
                  "chosen": mk.mlp_bwd_plan(dims) == plan, "events_ms": ms,
                  "device_ms": total, "kernels_ms": by_name, "bound_ms": bound[0],
                  "bound_by": bound[1], "peak_bytes": torch.cuda.max_memory_allocated(dev)})
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "device": torch.cuda.get_device_name(0)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
