#!/usr/bin/env python3
"""Where the grid forward's (K1, ``csrc/grid_fwd.cu``), the fused MLP
forward's (K2, ``csrc/mlp_fwd.cu``), the fused inference's (K3,
``csrc/fused_infer.cu``) and the fused MLP backward's (K5,
``csrc/mlp_bwd.cu``) time goes: time them through copies of the kernel
library, each with one part of one kernel removed or simplified, on one
CUDA GPU:

    python3 scripts/ablate_mlp_kernels.py [--checkout DIR] [VARIANT ...]

Variants, each built from the checkout's sources (DIR, default the checkout
holding this script, for example a parent commit unpacked with `git
archive`) with text edits made in a temporary directory (the package's own
sources and library are not touched; each variant's edits alone, and only
the sources of the kernels it times):
  full          the kernels as they are;
  k1-noload     K1 whose walker is grid_common.cuh:grid_level (one thread a
                (sample, level)) without its table loads (positions,
                weights, rows and stores only);
  k1-line       that K1 with every corner of a level reading within the
                128-byte line of the level's corner-0 row (one line a
                (sample, level); each corner keeps its own load);
  k1-i32        that K1 with its (sample, level) split in 32-bit integers;
  k1-nostore    that K1 without its output stores;
  k1p-single    K1 on its walker (grid_common.cuh:grid_level_pair, D fixed
                at compile time) with each thread loading all 2^D corners
                of its own level itself (no shared loads, no shuffles);
  k1p-noload    the pair K1 without its table loads;
  k1p-sector    the pair K1 with each lane loading, for each level, its
                slot-0 corner row again for every slot (a compiler barrier
                between the loads keeps each one): corners 0 and 1 only,
                mostly one 32-byte sector a (sample, level);
  k1p-l1        the pair K1 with every row taken modulo 256 (the first 1 KB
                of the table, which stays in each SM's L1);
  k1p-noshfl    the pair K1 without the exchange (each lane sums its own
                rows twice);
  k1p-nostore   the pair K1 without its output stores;
  k2-load       K2 without its input copy (each warp runs the chain on
                whatever its shared rows hold);
  k2-mlp        K2 without its layer chain (the input copy only);
  k3-mlp        K3 without its layer chain (the gather only; the output is
                not written);
  k3-gather     K3 without the gather (the encoding computed from the row
                and level, no table read);
  k3-unroll2    K3's gather loop unrolled twice (two (sample, level) pairs a
                lane in flight);
  generic-act   K3 and K5 built as for any activation, through
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
The k1-* variants apply to a checkout whose K1 calls grid_level, the
k1p-* ones to one whose K1 calls grid_level_pair; a variant whose edits do
not match the checkout raises. A removed part's time is full - variant.
Naming variants runs those and "full" only; "full" times every kernel the
named variants time. Timed with CUDA events (50 launches, best of two
turns, variants in turns) at B = 2^18 on data/config_hash.json, the table
redrawn from U(-1, 1): K1 (grid_encode), K2 (mlp_forward on the encoding),
K3, K5 on a random bf16 cotangent, also at width 128 with 5 hidden layers
("K5 128x5"). Prints one JSON line with the card's nvidia-smi name and
power limit.
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

ARGS = sys.argv[1:]
CHECKOUT = ARGS[ARGS.index("--checkout") + 1] if "--checkout" in ARGS else None
CHOSEN = [a for i, a in enumerate(ARGS)
          if a != "--checkout" and (i == 0 or ARGS[i - 1] != "--checkout")]
ROOT = pathlib.Path(CHECKOUT or pathlib.Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(ROOT))

B = 1 << 18
ITERS = 50
#: The sources each timed kernel's library needs beside grid_fwd.cu (the
#: error strings) and mlp_fwd.cu (the MLP gate's tcnn_mlp_tile).
SOURCES = {"K1": (), "K2": (), "K3": ("fused_infer.cu",), "K5": ("mlp_bwd.cu",),
           "K5 128x5": ("mlp_bwd.cu",)}
_K3_MLP = (r"frag_forward<WIDTH, ACT, OUT_ACT>\((?:.|\n)*?16 \* p, o\); \}\);",
           "if (xs[lane] == __float2bfloat16_rn(12345.f)) out[0] = xs[0];")
_K3_LB = r"__launch_bounds__\(256, WIDTH <= 64 \? 4 : 2\)"
#: A K1 that calls grid_level (one thread a (sample, level)): the pattern
#: matches only there, and leaves the source as it is.
_K1_LEVEL = (r"grid_level<F>\(g, b, l, v\);", "grid_level<F>(g, b, l, v);")
_LEVEL_LOAD = (r"(grid_corners\(g, b, l, \[&\]\(unsigned row, float cw\) \{\n    float v\[F\];\n"
               r"    )load_bf16<F>\(g\.table \+ \(size_t\)row \* F, v\);")
#: A K1 that calls grid_level_pair, and its table load.
_K1_PAIR = (r"grid_level_pair<F, D>\(g, b, l, b < B, n_active, v\);",
            "grid_level_pair<F, D>(g, b, l, b < B, n_active, v);")
_PAIR_LOAD = (r"mine\[q\]\[j\] = \*reinterpret_cast<const Raw\*>\(\n"
              r"            g\.table \+ \(size_t\)corner_row<D>\(g, k\[q\], cell\[q\], c\) \* F\);")
#: (name, kernels timed, {source: [(pattern, replacement)]}): every pattern
#: must match exactly once.
VARIANTS = (
    ("full", (), {}),
    ("k1-noload", ("K1",), {"grid_fwd.cu": [_K1_LEVEL], "grid_common.cuh": [
        (_LEVEL_LOAD, r"\1for (int f = 0; f < F; ++f) v[f] = (float)(row & 15u);")]}),
    ("k1-line", ("K1",), {"grid_fwd.cu": [_K1_LEVEL], "grid_common.cuh": [
        (_LEVEL_LOAD, r"\1if (first == 0xffffffffu) first = row;\n"
                      r"    load_bf16<F>(g.table + (((size_t)first * F) & ~(size_t)63)"
                      r" + (((size_t)row * F) & 63), v);"),
        (r"(  for \(int f = 0; f < F; \+\+f\) out\[f\] = 0\.f;\n)(  grid_corners\(g, b, l,)",
         r"\1  unsigned first = 0xffffffffu;\n\2")]}),
    ("k1-i32", ("K1",), {"grid_fwd.cu": [
        (r"const long t = \(long\)blockIdx\.x \* blockDim\.x \+ threadIdx\.x;\n"
         r"  if \(t >= B \* g\.L\) return;\n  const long b = t / g\.L;\n"
         r"  const int l = \(int\)\(t % g\.L\);",
         "const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;\n"
         "  if (t >= (unsigned)(B * g.L)) return;\n  const unsigned b = t / (unsigned)g.L;\n"
         "  const int l = (int)(t % (unsigned)g.L);")]}),
    ("k1-nostore", ("K1",), {"grid_fwd.cu": [
        _K1_LEVEL,
        (r"  bf16\* row = out \+ b \* out_width;\n  store_bf16<F>\(row \+ l \* F, v\);",
         "  bf16* row = out + b * out_width;\n"
         "  if (v[0] == 12345.f) store_bf16<F>(row + l * F, v);")]}),
    ("k1p-single", ("K1",), {"grid_fwd.cu": [_K1_PAIR], "grid_common.cuh": [
        (r"constexpr int H = 1 << \(D - 1\);", "constexpr int H = 1 << D;"),
        (r"const int c = 2 \* j \+ xbit;", "const int c = j;"),
        (r"if \(active\[q\] && !\(nearest && c > 0\)\) \{",
         "if (q == xbit && active[q] && !(nearest && c > 0)) {"),
        (r"for \(int j = 0; j < H; \+\+j\) theirs\[j\] = shfl_pair\(xbit \? mine\[0\]\[j\] "
         r": mine\[1\]\[j\]\);", ""),
        (r"unpack_bf16<F>\(\(c & 1\) == xbit \? \(xbit \? mine\[1\]\[c >> 1\] : "
         r"mine\[0\]\[c >> 1\]\) : theirs\[c >> 1\],\n\s*v\);",
         "unpack_bf16<F>(xbit ? mine[1][c] : mine[0][c], v);")]}),
    ("k1p-noload", ("K1",), {"grid_fwd.cu": [_K1_PAIR], "grid_common.cuh": [
        (_PAIR_LOAD, "const unsigned r = corner_row<D>(g, k[q], cell[q], c) & 15u;\n"
                     "        Raw z{};\n        memcpy(&z, &r, 2);\n        mine[q][j] = z;")]}),
    ("k1p-sector", ("K1",), {"grid_fwd.cu": [_K1_PAIR], "grid_common.cuh": [
        (_PAIR_LOAD, "const unsigned r = corner_row<D>(g, k[q], cell[q], c);\n"
                     "        if (j == 0) first[q] = r;\n"
                     "        asm volatile(\"\" ::: \"memory\");\n"
                     "        mine[q][j] = *reinterpret_cast<const Raw*>(g.table + (size_t)first[q] * F);"),
        (r"(  Raw mine\[2\]\[H\], theirs\[H\];\n)", r"\1  unsigned first[2] = {0u, 0u};\n")]}),
    ("k1p-l1", ("K1",), {"grid_fwd.cu": [_K1_PAIR], "grid_common.cuh": [
        (_PAIR_LOAD, "mine[q][j] = *reinterpret_cast<const Raw*>(\n"
                     "            g.table + (size_t)(corner_row<D>(g, k[q], cell[q], c) & 255u) * F);")]}),
    ("k1p-noshfl", ("K1",), {"grid_fwd.cu": [_K1_PAIR], "grid_common.cuh": [
        (r"theirs\[j\] = shfl_pair\(xbit \? mine\[0\]\[j\] : mine\[1\]\[j\]\);",
         "theirs[j] = xbit ? mine[0][j] : mine[1][j];")]}),
    ("k1p-nostore", ("K1",), {"grid_fwd.cu": [
        _K1_PAIR, (r"    store_bf16<F>\(row \+ l \* F, v\);",
                   "    if (v[0] == 12345.f) store_bf16<F>(row + l * F, v);")]}),
    ("k2-load", ("K2",), {"mlp_fwd.cu": [
        (r"    for \(int i = lane; i < 16 \* chunks; i \+= 32\) \{(?:.|\n)*?\n    \}\n"
         r"    __syncwarp\(\);", "    __syncwarp();")]}),
    ("k2-mlp", ("K2",), {"mlp_fwd.cu": [_K3_MLP]}),
    ("k3-mlp", ("K3",), {"fused_infer.cu": [_K3_MLP]}),
    ("k3-gather", ("K3",), {"fused_infer.cu": [
        (r"grid_level<F>\(g, row0 \+ r, l, v\);",
         "for (int f = 0; f < F; ++f) v[f] = 0.001f * (float)(r + l + f);")]}),
    ("k3-unroll2", ("K3",), {"fused_infer.cu": [
        (r"(    for \(int p = lane; p < 16 \* g\.L; p \+= 32\) \{)", "#pragma unroll 2\n\\1")]}),
    ("generic-act", ("K3", "K5"), {"mlp_frag.cuh": [
        (r"if \(act == ACT_RELU && out_act == ACT_NONE\) \{", "if (false) {")]}),
    ("k5-wgrad", ("K5",), {"mlp_bwd.cu": [
        (r"if \(u >= 0 && u < n_i\) unit_mma\(acc\[k\][^;]*;", ";")]}),
    ("k3-lb5", ("K3",), {"fused_infer.cu": [(_K3_LB, "__launch_bounds__(256, WIDTH <= 64 ? 5 : 2)")]}),
    ("k3-lb6", ("K3",), {"fused_infer.cu": [(_K3_LB, "__launch_bounds__(256, WIDTH <= 64 ? 6 : 2)")]}),
    ("k3-mlp-lb6", ("K3",), {"fused_infer.cu": [
        _K3_MLP, (_K3_LB, "__launch_bounds__(256, WIDTH <= 64 ? 6 : 2)")]}),
    ("k3-mlp-lb8", ("K3",), {"fused_infer.cu": [
        _K3_MLP, (_K3_LB, "__launch_bounds__(256, WIDTH <= 64 ? 8 : 2)")]}),
    ("k3-lb3", ("K3",), {"fused_infer.cu": [(_K3_LB, "__launch_bounds__(256, WIDTH <= 64 ? 3 : 2)")]}),
    ("k5-spill1", ("K5", "K5 128x5"), {"mlp_bwd.cu": [
        (r"K5_SPILL_BATCH = WIDTH > 64 \? 4 : 1;", "K5_SPILL_BATCH = 1;")]}),
    ("k5-rolled", ("K5", "K5 128x5"), {"mlp_bwd.cu": [
        (r"#pragma unroll 4\n  for \(int r = 0; r < nt;", "  for (int r = 0; r < nt;")]}),
)


def chosen_variants():
    """[(name, kernels)] of the variants to run: the named ones and "full",
    which times every kernel they time (all kernels when none is named)."""
    names = {name for name, _, _ in VARIANTS}
    unknown = [c for c in CHOSEN if c not in names]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}")
    picked = [(n, k, e) for n, k, e in VARIANTS if n != "full" and (not CHOSEN or n in CHOSEN)]
    union = tuple(k for k in SOURCES if any(k in ks for _, ks, _ in picked)) or tuple(SOURCES)
    return [("full", union, {})] + picked


def build_variants(tmp: pathlib.Path, variants) -> dict:
    """{variant: path of its library}: each variant's sources (those of the
    kernels it times) compiled into their own directory, all at once."""
    from tcnn_tpu_torch.ops.cuda import _build

    nvcc = _build._nvcc()
    cmds, dirs = [], {}
    for name, kernels, edits in variants:
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
        needed = {"grid_fwd.cu", "mlp_fwd.cu"} | {s for k in kernels for s in SOURCES[k]}
        cmds += [[nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(vdir / (src[:-3] + ".o")),
                  str(vdir / src)] for src in sorted(needed)]
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
    variants = chosen_variants()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for name, path in build_variants(pathlib.Path(tmp), variants).items():
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
        plan, dims, L = prep.plan, prep.dims, prep.plan.n_levels
        x = torch.rand(B, 2, generator=gen).cuda()
        enc = grid_kernel._grid_encode_plain(plan, prep.table, x, dims.in_w, L)
        gy = torch.randn(B, dims.out_w, generator=gen).to(torch.bfloat16).cuda()
        dims128 = mlp_kernel.MlpDims(dims.in_w, 128, 5, 16, dims.activation,
                                     dims.output_activation)
        w128 = (torch.rand(dims128.n_weights, generator=gen) * 0.2 - 0.1).to(torch.bfloat16)
        w128 = w128.cuda()
        kernels = {"K1": lambda: grid_kernel.grid_encode(plan, prep.table, x, dims.in_w, L),
                   "K2": lambda: mlp_kernel.mlp_forward(dims, prep.weights, enc),
                   "K3": lambda: train_kernel.fused_forward_prepared(prep, x),
                   "K5": lambda: mlp_kernel.mlp_backward(dims, prep.weights, enc, gy),
                   "K5 128x5": lambda: mlp_kernel.mlp_backward(dims128, w128, enc, gy)}
        timed = {name: ks for name, ks, _ in variants}
        ms = {k: {name: [] for name in libs if k in timed[name]} for k in kernels}
        for _ in range(2):
            for name, lib in libs.items():
                _build._lib = lib
                for k in timed[name]:
                    fn = kernels[k]
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
        ms = {k: t for k, t in ms.items() if t}
        print(json.dumps({"B": B, "card": smi, "checkout": str(ROOT),
                          "ms": {k: {n: min(v) for n, v in t.items()} for k, t in ms.items()},
                          "turns_ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
