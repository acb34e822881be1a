#!/usr/bin/env python3
"""Times of the PPNG table kernels K10-K13 (``csrc/ext_gather.cu``,
``csrc/ext_scatter.cu``) at the shapes phase 10 of chip_smoke.py times, on
one CUDA GPU, through the checkout's public wrappers:

    python3 scripts/time_ext_kernels.py [CHECKOUT] [--budgets] [--plans] [--ptxas]

CHECKOUT (default: the checkout holding this script) is the root of the
checkout whose `tcnn_tpu_torch` is built and timed, so the same file times
another commit's kernels, for example a parent commit unpacked with
`git archive`: run parent, this, this, parent in one call on one card and
compare within it. Each checkout builds its own library, of the PPNG
kernels' sources only (and grid_fwd.cu, which holds the error strings).

Shapes, the rows from each encoding's own `indices` at uniform points,
random cotangents, weights and tables from one seed: PPNG1, PPNG2 and PPNG3
at the factory defaults (ppng_1.h:340-378), B = 2^17, and at the SDF
sample's configs (samples/learn_a_sdf.py:ENCODINGS), B = 2^16 and the
eikonal term's 1024 points; and "hot": every sample at one point (0.5, 0,
1), B = 2^16 - 37, at the sample configs, so that every pick of a column
lands on one row. K10 and K11 for PPNG1/2 (K11 with the checkout's plan
where its wrapper takes the levels), K12 and K13 for PPNG3 (K13 with both
halves, the table half alone and the dots alone); each output held against
its plain twin (`err`: K10 and K12 max |diff|, K11 and K13 norm-relative,
their dots max |diff|); K12 also on the hot input. Timed with CUDA events (50 launches, best of two
turns; the wrapper's call, its output's zeroing included), and again under
torch.profiler for each call's device time by kernel (10 launches). With
--budgets, K11 also under each shared-memory budget of BUDGETS, set as
ext_kernel.K11_PRIVATE_BYTES (0: every level global). With --plans, K12
at PPNG3's shapes in each block size of PLAN_THREADS (set in place of
ext_kernel.lookup_threads), each held bit for bit against the twin
(`plans_equal`) and timed PLAN_TURNS times, the sizes in turns
(`plans_device_ms`: each turn's profiler device ms, 0 where the
profiler recorded no kernel). With --ptxas,
`nvcc -Xptxas -v` of the checkout's ext_gather.cu and ext_scatter.cu at
the build's flags: each kernel's
registers, shared memory and spills. Prints one JSON line with the card's
`nvidia-smi` name and power limit. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import inspect
import json
import pathlib
import re
import subprocess
import sys
import tempfile

ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
ROOT = pathlib.Path(ARGS[0] if ARGS else __file__).resolve()
if ROOT.is_file():
    ROOT = ROOT.parents[1]
sys.path.insert(0, str(ROOT))

SEED = 1234
ITERS = 50
#: The library's sources this script builds.
SOURCES = ("ext_gather.cu", "ext_scatter.cu", "grid_fwd.cu")
#: K11's shared-memory budgets under --budgets (bytes a block).
BUDGETS = (0, 34_816, 115_712, 232_448)
#: K12's block sizes under --plans, and the turns each is timed in.
PLAN_THREADS = (64, 128, 256)
PLAN_TURNS = 5


def cuda_ms(fn):
    import torch

    for _ in range(3):
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
    """(device ms a call: the sum of its CUDA kernels' times under
    torch.profiler, {kernel name: ms a call})"""
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


def ptxas_readings():
    """{kernel: ptxas's 'Used ...' and spill lines} of ext_gather.cu and
    ext_scatter.cu."""
    from tcnn_tpu_torch.ops.cuda import _build

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in ("ext_gather.cu", "ext_scatter.cu"):
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_ext_kernels: no CUDA device available", file=sys.stderr)
        return 1
    from tcnn_tpu_torch.ops.cuda import _build
    from tcnn_tpu_torch.ops.cuda import ext_kernel as ek
    from tcnn_tpu_torch.ops.encodings import ppng
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    cu, cuh = _build._sources()
    _build._sources = lambda: ([p for p in cu if p.name in SOURCES], cuh)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    takes_levels = "n_levels" in inspect.signature(ek.ext_scatter).parameters
    ms, dev_ms, err, plans_equal, plans_dev_ms, k12_threads = {}, {}, {}, {}, {}, {}

    def timed(key, fn):
        ms[key] = cuda_ms(fn)
        dev_ms[key] = device_ms(fn)

    classes = {"PPNG1": ppng.PPNG1Encoding, "PPNG2": ppng.PPNG2Encoding,
               "PPNG3": ppng.PPNG3Encoding}
    cases = [(v, "defaults", {}, 1 << 17, None) for v in classes]
    for v in classes:
        cfg = {k: x for k, x in sdf.ENCODINGS[v].items() if k != "otype"}
        cases += [(v, "sample", cfg, 1 << 16, None), (v, "sample", cfg, sdf.N_EIKONAL, None),
                  (v, "hot", cfg, (1 << 16) - 37, (0.5, 0.0, 1.0))]
    for variant, tag, cfg, B, point in cases:
        enc = classes[variant](3, **cfg)
        spec = enc.spec
        if point is None:
            x = torch.rand(B, 3, generator=gen).to(dev)
        else:
            x = torch.tensor(point, dtype=torch.float32).expand(B, 3).contiguous().to(dev)
        idx, w = enc.indices(x)
        name = f"{variant} {tag} B={B}"
        tbl = (torch.rand(spec.n_rows, spec.f, generator=gen) * 2 - 1).to(spec.dtype).to(dev)
        if variant != "PPNG3":
            ct = torch.randn(B, idx.shape[1] * spec.f, generator=gen).to(spec.dtype).to(dev)
            lv = {"n_levels": spec.n_levels} if takes_levels else {}
            err[f"K10 {name}"] = float((ek.ext_gather(tbl, idx).float()
                                        - ek._ext_gather_plain(tbl, idx).float()).abs().max())
            err[f"K11 {name}"] = norm_rel(ek.ext_scatter(idx, ct, spec.n_rows, **lv),
                                          ek._ext_scatter_plain(idx, ct, spec.n_rows))
            if tag != "hot":
                timed(f"K10 {name}", lambda: ek.ext_gather(tbl, idx))
            timed(f"K11 {name}", lambda: ek.ext_scatter(idx, ct, spec.n_rows, **lv))
            if "--budgets" in sys.argv and takes_levels:
                default = ek.K11_PRIVATE_BYTES
                for ek.K11_PRIVATE_BYTES in BUDGETS:
                    timed(f"K11 {name} budget={ek.K11_PRIVATE_BYTES}",
                          lambda: ek.ext_scatter(idx, ct, spec.n_rows, spec.n_levels))
                ek.K11_PRIVATE_BYTES = default
            continue
        NL = spec.n_levels
        cw = w.contiguous()
        gy = torch.randn(B, NL * spec.f, generator=gen).to(torch.bfloat16).float().to(dev)
        err[f"K12 {name}"] = float((ek.ext_lookup(tbl, idx, cw, NL).float()
                                    - ek._ext_lookup_plain(tbl, idx, cw, NL).float()).abs().max())
        dT, dcw = ek.ext_lookup_bwd(tbl, idx, cw, gy, spec.n_rows, NL)
        wT, wcw = ek._ext_lookup_bwd_plain(tbl, idx, cw, gy, spec.n_rows, NL, True, True)
        err[f"K13 {name} table"] = norm_rel(dT, wT)
        err[f"K13 {name} dots"] = float((dcw - wcw).abs().max())
        timed(f"K12 {name}", lambda: ek.ext_lookup(tbl, idx, cw, NL))
        if hasattr(ek, "lookup_threads"):
            n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
            k12_threads[name] = ek.lookup_threads(B * NL, n_sm)
        if "--plans" in sys.argv and hasattr(ek, "lookup_threads"):
            default = ek.lookup_threads
            want = ek._ext_lookup_plain(tbl, idx, cw, NL).view(torch.int16)
            for turn in range(PLAN_TURNS):
                for threads in PLAN_THREADS:
                    ek.lookup_threads = lambda *_a, t=threads: t
                    key = f"K12 {name} threads={threads}"
                    if turn == 0:
                        plans_equal[key] = bool(torch.equal(
                            ek.ext_lookup(tbl, idx, cw, NL).view(torch.int16), want))
                    plans_dev_ms.setdefault(key, []).append(
                        device_ms(lambda: ek.ext_lookup(tbl, idx, cw, NL))[0])
            ek.lookup_threads = default
        for half, kw in (("", {}), (" table", dict(want_dots=False)),
                         (" dots", dict(want_table=False))):
            timed(f"K13 {name}{half}",
                  lambda kw=kw: ek.ext_lookup_bwd(tbl, idx, cw, gy, spec.n_rows, NL, **kw))
    print(json.dumps({"checkout": str(ROOT), "card": smi, "ms": ms, "device_ms": dev_ms,
                      "err": err, "k12_threads": k12_threads, "plans_equal": plans_equal,
                      "plans_device_ms": plans_dev_ms,
                      "build_s": _build.build_seconds,
                      "ptxas": ptxas_readings() if "--ptxas" in sys.argv else None}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
