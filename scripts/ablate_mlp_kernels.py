#!/usr/bin/env python3
"""Where K3's and K5's time goes: time the fused inference (K3,
``csrc/fused_infer.cu``) and the fused MLP backward (K5, ``csrc/mlp_bwd.cu``)
through copies of the kernel library, each with one part of one kernel
removed or simplified, on one CUDA GPU:

    python3 scripts/ablate_mlp_kernels.py [VARIANT ...]

Variants, each built from this checkout's sources with text edits made in a
temporary directory (the package's own sources and library are not
touched; each variant's edits alone):
  full          the kernels as they are;
  k3-mlp        K3 without its layer chain (the gather only; the output is
                not written);
  k3-gather     K3 without the gather (the encoding computed from the row
                and level, no table read);
  k3-unroll2    K3's gather loop unrolled twice (two (sample, level) pairs a
                lane in flight);
  generic-act   both kernels built as for any activation, through
                apply_act's run-time switch (mlp_frag.cuh:with_acts never
                takes the ReLU / None instantiation);
  k5-wgrad      K5 without the register units' weight-gradient products;
  k3-lb5, k3-lb6  K3 held to 5 or 6 blocks of 8 warps an SM (51 or 42
                registers a thread) in place of 4 (64);
  k3-lb3        K3 held to 3 blocks an SM (85 registers) in place of 4;
  k5-rolled     K5's weight-gradient row loop (unit_mma) not unrolled;
  k5-spill1     K5's units past the registers carried one at a time at
                width 128 too (not four);
  k3-mlp-lb6, k3-mlp-lb8  k3-mlp held to 6 or 8 blocks an SM (42 or 32
                registers): how the gather alone scales with resident warps.
A removed part's time is full - variant. Naming variants runs those and
"full" only. Timed with CUDA events (50
launches, best of two turns, variants in turns) at B = 2^18 on
data/config_hash.json, the table redrawn from U(-1, 1), and K5 on a random
bf16 cotangent, also at width 128 with 5 hidden layers ("K5 128x5"). Prints one JSON line with the card's nvidia-smi name and
power limit. Run it from the root of any checkout of the port (the script
reads the package beside it).
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
#: (name, {source: [(pattern, replacement)]}): every pattern must match
#: exactly once.
VARIANTS = (
    ("full", {}),
    ("k3-mlp", {"fused_infer.cu": [
        (r"frag_forward<WIDTH, ACT, OUT_ACT>\((?:.|\n)*?16 \* p, o\); \}\);",
         "if (xs[lane] == __float2bfloat16_rn(12345.f)) out[0] = xs[0];")]}),
    ("k3-gather", {"fused_infer.cu": [
        (r"grid_level<F>\(g, row0 \+ r, l, v\);",
         "for (int f = 0; f < F; ++f) v[f] = 0.001f * (float)(r + l + f);")]}),
    ("k3-unroll2", {"fused_infer.cu": [
        (r"(    for \(int p = lane; p < 16 \* g\.L; p \+= 32\) \{)", "#pragma unroll 2\n\\1")]}),
    ("generic-act", {"mlp_frag.cuh": [
        (r"if \(act == ACT_RELU && out_act == ACT_NONE\) \{", "if (false) {")]}),
    ("k5-wgrad", {"mlp_bwd.cu": [
        (r"if \(u >= 0 && u < n_i\) unit_mma\(acc\[k\][^;]*;", ";")]}),
    ("k3-lb5", {"fused_infer.cu": [(r"__launch_bounds__\(256, WIDTH <= 64 \? 4 : 2\)",
                                    "__launch_bounds__(256, WIDTH <= 64 ? 5 : 2)")]}),
    ("k3-lb6", {"fused_infer.cu": [(r"__launch_bounds__\(256, WIDTH <= 64 \? 4 : 2\)",
                                    "__launch_bounds__(256, WIDTH <= 64 ? 6 : 2)")]}),
    ("k3-mlp-lb6", {"fused_infer.cu": [
        (r"frag_forward<WIDTH, ACT, OUT_ACT>\((?:.|\n)*?16 \* p, o\); \}\);",
         "if (xs[lane] == __float2bfloat16_rn(12345.f)) out[0] = xs[0];"),
        (r"__launch_bounds__\(256, WIDTH <= 64 \? 4 : 2\)",
         "__launch_bounds__(256, WIDTH <= 64 ? 6 : 2)")]}),
    ("k3-mlp-lb8", {"fused_infer.cu": [
        (r"frag_forward<WIDTH, ACT, OUT_ACT>\((?:.|\n)*?16 \* p, o\); \}\);",
         "if (xs[lane] == __float2bfloat16_rn(12345.f)) out[0] = xs[0];"),
        (r"__launch_bounds__\(256, WIDTH <= 64 \? 4 : 2\)",
         "__launch_bounds__(256, WIDTH <= 64 ? 8 : 2)")]}),
    ("k3-lb3", {"fused_infer.cu": [(r"__launch_bounds__\(256, WIDTH <= 64 \? 4 : 2\)",
                                    "__launch_bounds__(256, WIDTH <= 64 ? 3 : 2)")]}),
    ("k5-spill1", {"mlp_bwd.cu": [(r"K5_SPILL_BATCH = WIDTH > 64 \? 4 : 1;",
                                   "K5_SPILL_BATCH = 1;")]}),
    ("k5-rolled", {"mlp_bwd.cu": [(r"#pragma unroll 4\n  for \(int r = 0; r < nt;",
                                   "  for (int r = 0; r < nt;")]}),
)


def build_variants(tmp: pathlib.Path) -> dict:
    """{variant: path of its library}: each variant's sources compiled
    into their own directory, all at once."""
    from tcnn_tpu_torch.ops.cuda import _build

    nvcc = _build._nvcc()
    cmds, dirs = [], {}
    chosen = sys.argv[1:]
    for name, edits in VARIANTS:
        if chosen and name != "full" and name not in chosen:
            continue
        vdir = tmp / f"v{len(dirs)}"
        shutil.copytree(_build.CSRC, vdir)
        for src, subs in edits.items():
            text = (vdir / src).read_text()
            for pattern, repl in subs:
                text, n = re.subn(pattern, repl, text)
                if n != 1:
                    raise RuntimeError(f"{name}: {pattern!r} matched {n} times in {src}")
            (vdir / src).write_text(text)
        dirs[name] = vdir
        cmds += [[nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(p.with_suffix(".o")), str(p)]
                 for p in sorted(vdir.glob("*.cu"))]
    _build._run_all(cmds)
    libs = {name: vdir / "lib.so" for name, vdir in dirs.items()}
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(libs[name]),
                      *map(str, sorted(vdir.glob("*.o")))] for name, vdir in dirs.items()])
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_mlp_kernels: no CUDA device available", file=sys.stderr)
        return 1
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.ops.cuda import _build, grid_kernel, mlp_kernel, train_kernel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for name, path in build_variants(pathlib.Path(tmp)).items():
            lib = ctypes.CDLL(str(path))
            lib.tcnn_error_string.argtypes = [ctypes.c_int]
            lib.tcnn_error_string.restype = ctypes.c_char_p
            libs[name] = lib
        cfg = tt.load_config(str(ROOT / "data" / "config_hash.json"))
        gen = torch.Generator().manual_seed(1234)
        m = tt.create_from_config(2, 3, cfg, seed=1234, device="cuda")
        tr, net = m.trainer, m.network
        p = tr.params.detach().clone()
        n_net = net.network.n_params
        p[n_net:] = (torch.rand(p.numel() - n_net, generator=gen) * 2 - 1).cuda()
        prep = train_kernel.prepare_forward(net, p)
        x = torch.rand(B, 2, generator=gen).cuda()
        enc = grid_kernel._grid_encode_plain(prep.plan, prep.table, x, prep.dims.in_w,
                                             prep.plan.n_levels)
        gy = torch.randn(B, prep.dims.out_w, generator=gen).to(torch.bfloat16).cuda()
        dims128 = mlp_kernel.MlpDims(prep.dims.in_w, 128, 5, 16, prep.dims.activation,
                                     prep.dims.output_activation)
        w128 = (torch.rand(dims128.n_weights, generator=gen) * 0.2 - 0.1).to(torch.bfloat16)
        w128 = w128.cuda()
        kernels = {"K3": lambda: train_kernel.fused_forward_prepared(prep, x),
                   "K5": lambda: mlp_kernel.mlp_backward(prep.dims, prep.weights, enc, gy),
                   "K5 128x5": lambda: mlp_kernel.mlp_backward(dims128, w128, enc, gy)}
        ms = {k: {name: [] for name in libs} for k in kernels}
        for _ in range(2):
            for name, lib in libs.items():
                _build._lib = lib
                for k, fn in kernels.items():
                    for _ in range(3):
                        fn()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    start.record()
                    for _ in range(ITERS):
                        fn()
                    end.record()
                    torch.cuda.synchronize()
                    ms[k][name].append(start.elapsed_time(end) / ITERS)
        _build._lib = None
        print(json.dumps({"B": B, "card": smi, "checkout": str(ROOT),
                          "ms": {k: {n: min(v) for n, v in t.items()} for k, t in ms.items()},
                          "turns_ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
