#!/usr/bin/env python3
"""Where K6's time goes: time the fused train step (K6, ``csrc/fused_train.cu``)
through copies of the kernel library in which the step loses one phase
more each time, on one CUDA GPU:

    python3 scripts/ablate_k6_phases.py [VARIANT ...]

Variants of ``fused_train.cuh``'s train step, each built from this
checkout's sources with text edits made in a temporary directory (the
package's own sources and library are not touched; only the F = 2 half,
``fused_train_f2.cu``, is rebuilt per variant, which is what both
configurations run):
  full       the step as it is;
  -scatter   step 5, the table-gradient scatter, removed;
  -backward  also step 4, the MLP backward (dgrad and wgrad), left as one
             barrier;
  -forward   also steps 2-3, the MLP forward and the loss;
  -gather    also step 1, the gather (`gather_rows`, or the
             per-(sample, level) loop of a checkout before it): the
             weights' load, the register units' store and the fixed-order
             reduce are left.
So the scatter takes full - (-scatter), the backward (-scatter) -
(-backward), the forward and loss (-backward) - (-forward), the gather
(-forward) - (-gather); the patterns match the gather of both forms, so one
copy of this script splits a checkout from before the lane-pair gather and
one after it. Each VARIANT named on the command line (EXTRA) is built
beside them, its edits made to the step as it is:
  reg-units-8      8 register units a warp (not 4).
The variants that edited the per-(sample, level) gather loop
(gather-unroll-2, -4 and block-gather) are retired with that loop. K6 is
timed with CUDA events around the whole call (50 launches, best of two
turns, variants in turns; `k6_ms`, `phases_ms`) and by its kernel's own
device time under torch.profiler (20 launches a turn; `k6_device_ms`,
`phases_device_ms`): once the step has lost its phases the call is the
host's (its operand preparation, ~0.15-0.2 ms), and only the device time
still splits what is left. At B = 2^18 on data/config_hash.json and at the
reference's default hash grid (log2_hashmap_size 19, per_level_scale 2.0),
the table redrawn from U(-1, 1). Prints one JSON line per configuration
with the card's nvidia-smi name and power limit. Run it from the root of
any checkout of the port (the script reads the package beside it).
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

B = 1 << 18
ITERS = 50
#: (name, [(pattern, replacement)]): each variant applies its own edits and
#: those of the variants before it; every pattern must match exactly once.
VARIANTS = (
    ("full", []),
    ("-scatter", [(r"if \(row < B\) grid_level_bwd<F>\([^;]*\);", ";")]),
    ("-backward", [(r"    // 4\. backward(?:.|\n)*?(?=    // 5\. scatter)", "    __syncthreads();\n")]),
    ("-forward", [(r"frag_forward<WIDTH, ACT, OUT_ACT>\((?:.|\n)*?\n        \}\);", ";")]),
    ("-gather", [(r"    // 1\. gather the warp's rows(?:.|\n)*?\n    __syncwarp\(\);\n", "")]),
)
#: (name, [(pattern, replacement)]): variants of the step as it is
EXTRA = (
    ("reg-units-8", [(r"TRAIN_REG_UNITS = 4;", "TRAIN_REG_UNITS = 8;")]),
)
#: the source rebuilt per variant: K6's F = 2 half
VARIANT_SOURCE = "fused_train_f2.cu"


def variant_headers(header: str, extra) -> list:
    """[(name, header text)]: VARIANTS, each with the edits of those before
    it, then the `extra` variants, each on `header` as it is; every pattern
    must match exactly once."""
    def edit(text, name, edits):
        for pattern, repl in edits:
            text, n = re.subn(pattern, repl, text)
            if n != 1:
                raise RuntimeError(f"{name}: {pattern!r} matched {n} times")
        return text

    out, text = [], header
    for name, edits in VARIANTS:
        text = edit(text, name, edits)
        out.append((name, text))
    return out + [(name, edit(header, name, edits)) for name, edits in extra]


def build_variants(tmp: pathlib.Path, extra=()) -> dict:
    """{variant: path of its library}: every source but VARIANT_SOURCE
    compiled once, VARIANT_SOURCE once per variant, all at once."""
    from tcnn_tpu_torch.ops.cuda import _build

    nvcc = _build._nvcc()
    src = tmp / "src"
    shutil.copytree(_build.CSRC, src)
    header = (src / "fused_train.cuh").read_text()
    base = [p for p in sorted(src.glob("*.cu")) if p.name != VARIANT_SOURCE]
    cmds = [[nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(tmp / f"{p.stem}.o"), str(p)] for p in base]
    variants = variant_headers(header, extra)
    for name, text in variants:
        vdir = tmp / f"v{len(cmds)}"
        shutil.copytree(src, vdir)
        (vdir / "fused_train.cuh").write_text(text)
        cmds.append([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(vdir / "variant.o"),
                     str(vdir / VARIANT_SOURCE)])
    _build._run_all(cmds)
    objs = [str(tmp / f"{p.stem}.o") for p in base]
    libs, links = {}, []
    for (name, _), cmd in zip(variants, cmds[len(base):]):
        lib = tmp / f"lib{len(libs)}.so"
        links.append([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib), *objs, cmd[-2]])
        libs[name] = lib
    _build._run_all(links)
    return libs


def kernel_device_ms(fn, iters=20) -> float:
    """Device ms a call of fused_train_kernel under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if "fused_train_kernel" in ev.key:
            t = getattr(ev, "self_device_time_total", None)
            total += (ev.self_cuda_time_total if t is None else t) / 1e3
    return total / iters


def split(ms: dict) -> dict:
    """The phases from the variants' times."""
    return {"scatter": ms["full"] - ms["-scatter"],
            "mlp_backward": ms["-scatter"] - ms["-backward"],
            "mlp_forward_and_loss": ms["-backward"] - ms["-forward"],
            "gather": ms["-forward"] - ms["-gather"],
            "rest": ms["-gather"]}


def use_library(lib, entries) -> None:
    """Launch the package's kernels from `lib`, whose entry points
    `entries` are bound (None, {}: the package's own library again, loaded
    at the next launch); the persistent grids are asked again."""
    from tcnn_tpu_torch.ops.cuda import _build

    _build._lib = lib
    _build._entries.clear()
    _build._entries.update(entries)
    _build._persistent_grid.cache_clear()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_k6_phases: no CUDA device available", file=sys.stderr)
        return 1
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.ops.cuda import _build, train_kernel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        extra = [v for v in EXTRA if v[0] in sys.argv[1:]]
        unknown = set(sys.argv[1:]) - {v[0] for v in EXTRA}
        if unknown:
            raise SystemExit(f"unknown variants {sorted(unknown)}; known: {[v[0] for v in EXTRA]}")
        for name, path in build_variants(pathlib.Path(tmp), extra).items():
            lib = ctypes.CDLL(str(path))
            libs[name] = (lib, _build._bind(lib))
        cfg = tt.load_config(str(ROOT / "data" / "config_hash.json"))
        gen = torch.Generator().manual_seed(1234)
        for label, enc in (("config_hash", {}),
                           ("reference T=2^19", {"log2_hashmap_size": 19, "per_level_scale": 2.0})):
            c = json.loads(json.dumps(cfg))
            c["encoding"].update(enc)
            m = tt.create_from_config(2, 3, c, seed=1234, device="cuda")
            tr, net = m.trainer, m.network
            p = tr.params.detach().clone()
            n_net = net.network.n_params
            p[n_net:] = (torch.rand(p.numel() - n_net, generator=gen) * 2 - 1).cuda()
            x = torch.rand(B, 2, generator=gen).cuda()
            t = torch.rand(B, 3, generator=gen).cuda()

            def step():
                train_kernel.fused_train_grads(net, tr.loss_fn, p, x, t, tr.loss_scale)

            ms = {name: [] for name in libs}
            dev_ms = {name: [] for name in libs}
            for _ in range(2):
                for name, (lib, entries) in libs.items():
                    use_library(lib, entries)
                    for _ in range(3):
                        step()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    start.record()
                    for _ in range(ITERS):
                        step()
                    end.record()
                    torch.cuda.synchronize()
                    ms[name].append(start.elapsed_time(end) / ITERS)
                    dev_ms[name].append(kernel_device_ms(step))
            best = {name: min(v) for name, v in ms.items()}
            dev = {name: min(v) for name, v in dev_ms.items()}
            print(json.dumps({"config": label, "B": B, "card": smi, "checkout": str(ROOT),
                              "k6_ms": best, "turns_ms": ms, "phases_ms": split(best),
                              "k6_device_ms": dev, "turns_device_ms": dev_ms,
                              "phases_device_ms": split(dev)}), flush=True)
        use_library(None, {})
    return 0


if __name__ == "__main__":
    sys.exit(main())
