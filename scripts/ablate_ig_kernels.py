#!/usr/bin/env python3
"""Where the input-gradient grid kernels' time goes: K7
(``grid_backward_ig``, ``csrc/grid_bwd_ig.cu``) and K8
(``grid_backward_bwd``, ``csrc/grid_bwd_bwd.cu``) timed through copies of
their sources, each with one part removed, on one CUDA GPU:

    python3 scripts/ablate_ig_kernels.py [--checkout DIR] [VARIANT ...]

Variants, each built from the checkout's ``grid_common.cuh``,
``grid_bwd_ig.cu`` and ``grid_bwd_bwd.cu`` (DIR, default the checkout
holding this script, for example a parent commit unpacked with `git
archive`) with text edits made in a temporary directory (the package's own
sources and library are not touched). These match the first-slice kernels
(one thread a (sample, level), F scalar atomics a corner):
  full          the kernels as they are;
  noatomic      every table-gradient atomic replaced by a store that never
                happens (a compare against 12345): loads and arithmetic
                only;
  noload        the table rows that the dots read replaced by the row's
                low bits (no table load; the scatter kept);
  spread        every atomic's row replaced by ((b L + l) 8 + c) mod 2^16:
                no hot row, neighbouring threads on neighbouring rows.
The p-* variants match the redesigned kernels (lane pairs, vector
atomics):
  p-noatomic    K7's and K8's vector atomics replaced by a store that
                never happens;
  p-noload      the lane pairs' table-row loads replaced by loads of
                rows 0-15 (the row's low bits: L1 hits);
  p-spread      every atomic's row replaced by the thread's index times 8
                plus the row's low 3 bits, mod 2^16;
  p-ctconst     K8 built for calls without a table cotangent: its
                ct_table branches removed at compile time (as a template
                parameter would remove them), so only its "K8" times
                (ct_table None, the eikonal step's call) mean anything.
A variant whose edits do not match the checkout raises. Naming variants
runs those and "full". Timed with CUDA events (50 launches, best of two
turns, variants in turns; each wrapper's call with its outputs' zeroing)
and, for each variant, the kernel's own device time under torch.profiler,
through the checkout's wrappers at the SDF sample's HashGrid (T = 2^17) on
the eikonal step's cotangents: the 1024 eikonal points, B = 2^16 and
B = 2^18 (scripts/time_ig_kernels.py's inputs). Prints one JSON line with
the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import shutil
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import time_ig_kernels as tik  # noqa: E402

ARGS = sys.argv[1:]
CHECKOUT = ARGS[ARGS.index("--checkout") + 1] if "--checkout" in ARGS else None
CHOSEN = [a for i, a in enumerate(ARGS)
          if a != "--checkout" and (i == 0 or ARGS[i - 1] != "--checkout")]
FILES = ("grid_common.cuh", "grid_bwd_ig.cu", "grid_bwd_bwd.cu")
#: The first-slice scatters: K7's (grid_common.cuh:grid_level_bwd_ig) and K8's.
_K7_ADD = (r"atomicAdd\(gtable \+ \(size_t\)row \* F \+ f,\s*"
           r"__bfloat162float\(__float2bfloat16_rn\(__fmul_rn\(cw, gy\[f\]\)\)\)\);")
_K8_ADD = (r"atomicAdd\(gtable2 \+ \(size_t\)row \* F \+ f,\s*"
           r"__bfloat162float\(__float2bfloat16_rn\(__fmul_rn\(gv\[f\], zw\)\)\)\);")
_SPREAD = "(size_t)((((unsigned long long)b * g.L + l) * 8ull + k.c) & 65535ull)"
#: The redesigned kernels' vector atomics (K4's, in grid_level_bwd, sit
#: deeper in grid_common.cuh).
_K7_ROW = r"atomic_add_row<F>\(gtable \+ \(size_t\)row\[q\]\[j\] \* F, v\);"
_K8_ROW = r"atomic_add_row<F>\(gtable2 \+ \(size_t\)row\[q\]\[j\] \* F, v\);"
_THREAD_ROW = ("(size_t)((((unsigned)blockIdx.x * blockDim.x + threadIdx.x) * 8u + "
               "(row[q][j] & 7u)) & 65535u)")
#: (name, [(file, pattern, replacement)]): every pattern must match exactly once.
VARIANTS = (
    ("full", []),
    ("noatomic", [
        ("grid_common.cuh", _K7_ADD,
         "{ const float c_ = __bfloat162float(__float2bfloat16_rn(__fmul_rn(cw, gy[f]))); "
         "if (c_ == 12345.f) gtable[(size_t)row * F + f] = c_; }"),
        ("grid_bwd_bwd.cu", _K8_ADD,
         "{ const float c_ = __bfloat162float(__float2bfloat16_rn(__fmul_rn(gv[f], zw))); "
         "if (c_ == 12345.f) gtable2[(size_t)row * F + f] = c_; }")]),
    ("noload", [
        ("grid_common.cuh",
         r"float v\[F\];\s*load_bf16<F>\(g\.table \+ \(size_t\)row \* F, v\);\s*float dot",
         "float v[F];\n    for (int f = 0; f < F; ++f) v[f] = (float)(row & 15);\n    float dot"),
        ("grid_bwd_bwd.cu", r"load_bf16<F>\(g\.table \+ \(size_t\)row \* F, v\);",
         "for (int f = 0; f < F; ++f) v[f] = (float)(row & 15);")]),
    ("spread", [
        ("grid_common.cuh", _K7_ADD,
         f"atomicAdd(gtable + {_SPREAD} * F + f, "
         "__bfloat162float(__float2bfloat16_rn(__fmul_rn(cw, gy[f]))));"),
        ("grid_bwd_bwd.cu", _K8_ADD,
         f"atomicAdd(gtable2 + {_SPREAD} * F + f, "
         "__bfloat162float(__float2bfloat16_rn(__fmul_rn(gv[f], zw))));")]),
    # the redesigned kernels (grid_bwd_ig.cu, grid_bwd_bwd.cu, grid_common.cuh:pair_loads)
    ("p-noatomic", [
        ("grid_bwd_ig.cu", _K7_ROW,
         "if (v[0] == 12345.f) gtable[(size_t)row[q][j] * F] = v[0];"),
        ("grid_bwd_bwd.cu", _K8_ROW,
         "if (v[0] == 12345.f) gtable2[(size_t)row[q][j] * F] = v[0];")]),
    ("p-noload", [("grid_common.cuh",
                   r"\*reinterpret_cast<const Raw\*>\(tab \+ \(size_t\)row\[q\]\[j\] \* F\)",
                   "*reinterpret_cast<const Raw*>(tab + (size_t)(row[q][j] & 15u) * F)")]),
    ("p-spread", [
        ("grid_bwd_ig.cu", _K7_ROW, f"atomic_add_row<F>(gtable + {_THREAD_ROW} * F, v);"),
        ("grid_bwd_bwd.cu", _K8_ROW, f"atomic_add_row<F>(gtable2 + {_THREAD_ROW} * F, v);")]),
    ("p-ctconst", [
        ("grid_bwd_bwd.cu", r"if \(ct_table\) pair_loads", "if (false) pair_loads"),
        ("grid_bwd_bwd.cu", r"if \(ct_table\) pair_swap", "if (false) pair_swap"),
        ("grid_bwd_bwd.cu", r"if \(ct_table\) \{", "if (false) {")]),
)


def chosen_variants():
    names = {"full", *CHOSEN} if CHOSEN else {n for n, _ in VARIANTS if not n.startswith("p-")}
    unknown = names - {n for n, _ in VARIANTS}
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    return [v for v in VARIANTS if v[0] in names]


def build_variants(tmp: pathlib.Path, variants) -> dict:
    """{variant: its library}: each variant's grid_fwd.cu (the error
    strings), grid_bwd_ig.cu and grid_bwd_bwd.cu compiled into its own
    library, all variants at once."""
    from tcnn_tpu_torch.ops.cuda import _build

    nvcc = _build._nvcc()
    cmds, libs = [], {}
    for name, subs in variants:
        vdir = tmp / name
        shutil.copytree(_build.CSRC, vdir)
        for file in FILES:
            text = (vdir / file).read_text()
            for f, pattern, repl in subs:
                if f != file:
                    continue
                text, n = re.subn(pattern, lambda _m, r=repl: r, text)
                if n != 1:
                    raise RuntimeError(f"{name}: {pattern!r} matched {n} times in {file}")
            (vdir / file).write_text(text)
        libs[name] = vdir / "lib.so"
        cmds.append([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(libs[name]),
                     *(str(vdir / s) for s in tik.GRID_SOURCES)])
    _build._run_all(cmds)
    out = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.tcnn_error_string.argtypes = [ctypes.c_int]
        lib.tcnn_error_string.restype = ctypes.c_char_p
        out[name] = lib
    return out


def kernel_device_ms(fn) -> float:
    """The device ms a call of the K7 / K8 kernels alone (their memsets
    left out)."""
    _, by_name = tik.device_ms(fn)
    return sum(t for k, t in by_name.items() if "grid_bwd" in k)


def main() -> int:
    root = tik.checkout_root([CHECKOUT] if CHECKOUT else [])
    import torch

    if not torch.cuda.is_available():
        print("ablate_ig_kernels: no CUDA device available", file=sys.stderr)
        return 1
    from tcnn_tpu_torch.ops.cuda import _build

    smi = tik.card_name()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(tik.SEED)
    tik.CASES = tuple(c for c in tik.CASES if c[0] in ("1024 T=2^17", "2^16", "2^18"))
    inputs = tik.case_inputs(dev, gen)
    fns = {}
    for label, (plan, table, x, gy_enc, z, ct) in inputs.items():
        for name, (kern, _) in tik.kernel_calls(plan, table, x, gy_enc, z, ct).items():
            if name in ("K7", "K8", "K8 ct_table"):
                fns[f"{name} {label}"] = kern
    variants = chosen_variants()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(pathlib.Path(tmp), variants)
        ms = {k: {name: [] for name in libs} for k in fns}
        kernel_ms = {k: {} for k in fns}
        for turn in range(2):
            for name, lib in libs.items():
                _build._lib = lib
                for k, fn in fns.items():
                    ms[k][name].append(tik.cuda_ms(fn, turns=1))
                    if turn == 0:
                        kernel_ms[k][name] = kernel_device_ms(fn)
        _build._lib = None
    print(json.dumps({"card": smi, "checkout": str(root), "iters": tik.ITERS,
                      "ms": {k: {n: min(v) for n, v in t.items()} for k, t in ms.items()},
                      "kernel_device_ms": kernel_ms, "turns_ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
