#!/usr/bin/env python3
"""Where the PPNG table kernels' time goes: K12 (``ext_lookup``) of
``csrc/ext_gather.cu``, K11 (``ext_scatter``) and K13 (``ext_lookup_bwd``)
of ``csrc/ext_scatter.cu`` timed through copies of those sources, each
with one part removed, on one CUDA GPU:

    python3 scripts/ablate_ext_kernels.py [--checkout DIR] [VARIANT ...]

Variants, each built from the checkout's ``ext_gather.cu`` and
``ext_scatter.cu`` (DIR, default the checkout holding this script, for
example a parent commit unpacked with `git archive`) with text edits made
in a temporary directory (the package's own sources and library are not
touched); each edit applies to whichever of the two files it matches:
  full          the kernels as they are;
  noatomic      every global atomic add replaced by a store that never
                happens (a compare against 12345): loads and arithmetic
                only;
  noload        K11 adding 1.0 in place of each cotangent (no ct read),
                K13's dots without their table-row loads (the row's low
                bits as values);
  spread        every pick's row replaced by its pick index modulo 2048
                (idx is still read): no hot row, consecutive picks on
                consecutive rows, each of the first 2048 rows taking the
                same count.
These edits match the first-slice kernels (one thread per (pick, feature)
for K11, one per pick for K13). The p-* variants match the redesigned
ones:
  p-noflush     K11's private copies never added to the gradient;
  p-noadd       K11's private route without its shared-memory adds (the
                warp sums kept);
  p-nosum       without the warp sums: every lane adds its own item (K11's
                private route: a wrong result where lanes share a slice;
                K13: one RED a lane);
  p-noload      K11's private route without its cotangent loads (the pick's
                low bits as values), K13's dots without their table-row
                loads;
  p-noatomic    K11's global route and K13's table half without their
                global atomics (a store that never happens).
The k12-* variants edit the first-slice K12 (a thread a (sample, level),
its corners in a run-time loop; since the redesign the kernel of C != 8,
an odd NL or an unaligned idx only, so they need a parent checkout to say
anything), the k12p-* ones the redesigned ext_lookup8_kernel:
  k12-norows, k12p-norows   no table-row loads (the row index's low bits
                as the row's values; idx and cw are still read);
  k12-synth, k12p-synth     idx and cw not read: each pick's row made from
                a hash of (sample, level) plus the corner's x, y, z bits
                at strides 1, 32, 1024 within 32,768 rows a level (the
                sample config's Q^3: the x-pairs as they are, 1/8 of a
                factory-default level), every weight 0.125.
A variant whose edits do not match the checkout raises. Naming variants
runs those and "full". Timed with CUDA
events (50 launches, best of two turns, variants in turns; `ms`) and by
the sum of the call's CUDA kernels under torch.profiler (10 launches,
best of the two turns; `device_ms`: events read host time where a launch
takes less than its host call) through the
checkout's wrappers at phase 10's shapes of chip_smoke.py, random
cotangents from one seed, the rows from each encoding's own `indices`
at uniform points: K11 at PPNG1 (the sample's config is the factory
default; B = 2^16, and 2^17 as phase 10 times the defaults), PPNG2's
sample config (B = 2^16) and its defaults (B = 2^17); K12 and K13 at
PPNG3's sample config (B = 2^16 and the eikonal term's 1024 points) and
defaults (B = 2^17), K13 with both halves, the table half alone and the
dots alone. Prints one JSON line with the card's nvidia-smi name and
power limit.
"""

from __future__ import annotations

import ctypes
import inspect
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

SEED = 1234
ITERS = 50
_K11_ADD = r"atomicAdd\(gtable \+ \(long\)idx\[p\] \* F \+ f, to_f32\(ct\[t\]\)\);"
_K13_ADD = (r"atomicAdd\(gtable \+ row \* F \+ f, round_bf16\(__fmul_rn\(w, g\[f\]\)\)\);")
#: The redesigned K11's private add: lanes that clash summed first.
_PRIVATE_ADD = (r"if \(\(!__any_sync\(0xffffffffu, clash\) \|\| warp_sum<V>\(key\[u\], "
                r"v\[u\]\)\) && key\[u\] != kNoRow\) \{")
#: The first-slice K12's row load, and the redesign's.
_K12_ROW = r"load_bf16<F>\(table \+ \(long\)idx\[k\] \* F, v\);"
_K12P_ROW = (r"raw\[j\]\[v\] = \*reinterpret_cast<const Raw\*>"
             r"\(table \+ \(long\)row\[j\]\[v\] \* F\);")
#: A synthesized row of corner C_ at level L_ of sample b (see k12-synth).
_SYNTH_ROW = ("((L_) * 32768 + (int)(((unsigned)b * 2654435761u + (unsigned)(L_) * 40503u "
              "+ (unsigned)(((C_) & 1) + (((C_) >> 1) & 1) * 32 + ((C_) >> 2) * 1024)) "
              "& 32767u))")
#: (name, [(pattern, replacement)]): every pattern must match exactly once
#: in the two sources.
VARIANTS = (
    ("full", []),
    ("noatomic", [
        (_K11_ADD, "{ const float v_ = to_f32(ct[t]); const long r_ = idx[p]; "
                   "if (v_ == 12345.f) gtable[r_ * F + f] = v_; }"),
        (_K13_ADD, "{ const float c_ = round_bf16(__fmul_rn(w, g[f])); "
                   "if (c_ == 12345.f) gtable[row * F + f] = c_; }")]),
    ("noload", [
        (_K11_ADD, "atomicAdd(gtable + (long)idx[p] * F + f, 1.0f);"),
        (r"load_bf16<F>\(table \+ row \* F, v\);",
         "for (int f = 0; f < F; ++f) v[f] = (float)(row & 15);")]),
    ("spread", [
        (_K11_ADD, "atomicAdd(gtable + (long)(((unsigned)idx[p] & 0x80000000u) | "
                   "(unsigned)(p & 2047)) * F + f, to_f32(ct[t]));"),
        (r"const long row = idx\[t\];",
         "const long row = (long)(((unsigned)idx[t] & 0x80000000u) | (unsigned)(t & 2047));")]),
    # the redesigned kernels (K11's private route, K13's warp sums)
    ("p-noflush", [(r"if \(any\) atomic_add_row<V>\(out \+ i, v\);",
                    "if (any && v[0] == 12345.f) atomic_add_row<V>(out + i, v);")]),
    ("p-noadd", [(_PRIVATE_ADD, "if ((!__any_sync(0xffffffffu, clash) || warp_sum<V>(key[u], "
                                "v[u])) && key[u] != kNoRow && v[u][0] == 12345.f) {")]),
    ("p-nosum", [(_PRIVATE_ADD, "if (key[u] != kNoRow) {"),
                 (r"if \(warp_sum<F>\(row\[u\], acc\) && row\[u\] != kNoRow\)",
                  "if (row[u] != kNoRow)")]),
    ("p-noload", [(r"load_vec<V>\(ct \+ p \* F \+ w\.s \* V, v\[u\]\);",
                   "v[u][0] = (float)(p & 7);"),
                  (r"load_bf16<F>\(table \+ \(long\)row\[u\] \* F, v\[u\]\);",
                   "for (int f = 0; f < F; ++f) v[u][f] = (float)(row[u] & 15);")]),
    ("p-noatomic", [(r"atomic_add_row<F>\(gtable \+ \(long\)row\[u\] \* F, acc\);",
                     "if (acc[0] == 12345.f) gtable[row[u]] = acc[0];"),
                    (r"atomic_add_row<V>\(gtable \+ \(long\)idx\[p\] \* F \+ w\.s \* V, v\);",
                     "if (v[0] == 12345.f) gtable[idx[p]] = v[0];")]),
    # K12, first-slice (the kernel of C != 8 since the redesign) and redesigned
    ("k12-norows", [(_K12_ROW, "for (int f_ = 0; f_ < F; ++f_) v[f_] = (float)(idx[k] & 15);")]),
    ("k12-synth", [(r"const float w = cw\[k\];", "const float w = 0.125f;"),
                   (_K12_ROW, "load_bf16<F>(table + (long)"
                    + _SYNTH_ROW.replace("L_", "l").replace("C_", "c") + " * F, v);")]),
    ("k12p-norows", [(_K12P_ROW, "{ Raw r_{}; reinterpret_cast<unsigned short*>(&r_)[0] = "
                                 "(unsigned short)(0x3f80 | (row[j][v] & 15)); "
                                 "raw[j][v] = r_; }")]),
    ("k12p-synth", [
        (r"load_vec<2>\(idx \+ base \+ \(long\)\(j \* 2 \+ q\) \* NL, row\[j\]\);",
         "for (int v_ = 0; v_ < 2; ++v_) row[j][v_] = "
         + _SYNTH_ROW.replace("L_", "l0 + v_").replace("C_", "j * 2 + q") + ";"),
        (r"w\[c\] = cw\[base \+ \(long\)c \* NL \+ q\];", "w[c] = 0.125f;")]),
)
#: The sources the variants edit and build.
SOURCES = ("ext_gather.cu", "ext_scatter.cu")


def chosen_variants():
    names = {"full", *CHOSEN} if CHOSEN else {v[0] for v in VARIANTS}
    unknown = names - {v[0] for v in VARIANTS}
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    return [v for v in VARIANTS if v[0] in names]


def build_variants(tmp: pathlib.Path, variants) -> dict:
    """{variant: its library}: each variant's ext_gather.cu and
    ext_scatter.cu compiled into its own library, all at once."""
    from tcnn_tpu_torch.ops.cuda import _build

    nvcc = _build._nvcc()
    cmds, libs = [], {}
    for name, subs in variants:
        vdir = tmp / name
        shutil.copytree(_build.CSRC, vdir)
        texts = {src: (vdir / src).read_text() for src in SOURCES}
        for pattern, repl in subs:
            total = 0
            for src in SOURCES:
                texts[src], n = re.subn(pattern, lambda _m, r=repl: r, texts[src])
                total += n
            if total != 1:
                raise RuntimeError(f"{name}: {pattern!r} matched {total} times")
        for src, text in texts.items():
            (vdir / src).write_text(text)
        libs[name] = vdir / "lib.so"
        cmds.append([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(libs[name]),
                     *(str(vdir / src) for src in SOURCES)])
    _build._run_all(cmds)
    return {name: ctypes.CDLL(str(path)) for name, path in libs.items()}


def shapes(dev, gen):
    """{name: (kernel, callable)} at phase 10's shapes."""
    import torch
    from tcnn_tpu_torch.ops.cuda import ext_kernel as ek
    from tcnn_tpu_torch.ops.encodings import ppng
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    def enc_of(otype, cfg):
        cls = {"PPNG1": ppng.PPNG1Encoding, "PPNG2": ppng.PPNG2Encoding,
               "PPNG3": ppng.PPNG3Encoding}[otype]
        kw = {k: v for k, v in cfg.items() if k != "otype"}
        return cls(3, **kw)

    takes_levels = "n_levels" in inspect.signature(ek.ext_scatter).parameters
    eik_gen = torch.Generator().manual_seed(SEED + 1)
    out = {}
    for otype, tag, B in (("PPNG1", "sample", 1 << 16), ("PPNG1", "defaults", 1 << 17),
                          ("PPNG2", "sample", 1 << 16),
                          ("PPNG2", "defaults", 1 << 17), ("PPNG3", "sample", 1 << 16),
                          ("PPNG3", "defaults", 1 << 17)):
        enc = enc_of(otype, sdf.ENCODINGS[otype] if tag == "sample" else {})
        spec = enc.spec
        x = torch.rand(B, 3, generator=gen).to(dev)
        idx, w = enc.indices(x)
        if otype != "PPNG3":
            ct = torch.randn(B, idx.shape[1] * spec.f, generator=gen).to(spec.dtype).to(dev)
            lv = {"n_levels": spec.n_levels} if takes_levels else {}
            out[f"K11 {otype} {tag}"] = (
                lambda idx=idx, ct=ct, n=spec.n_rows, lv=lv: ek.ext_scatter(idx, ct, n, **lv))
            continue
        NL = spec.n_levels
        tbl = (torch.rand(spec.n_rows, spec.f, generator=gen) * 2 - 1).to(torch.bfloat16).to(dev)
        gy = torch.randn(B, NL * spec.f, generator=gen).to(torch.bfloat16).float().to(dev)
        cw = w.contiguous()
        looks = [(B, idx, cw)]
        if tag == "sample":  # the eikonal term's points, from their own generator
            ie, we = enc.indices(torch.rand(sdf.N_EIKONAL, 3, generator=eik_gen).to(dev))
            looks.append((sdf.N_EIKONAL, ie, we.contiguous()))
        for n, li, lw in looks:
            out[f"K12 {otype} {tag} B={n}"] = (
                lambda li=li, lw=lw, tbl=tbl, NL=NL: ek.ext_lookup(tbl, li, lw, NL))
        for half, kw in (("both", {}), ("table", dict(want_dots=False)),
                         ("dots", dict(want_table=False))):
            out[f"K13 {otype} {tag} {half}"] = (
                lambda idx=idx, cw=cw, gy=gy, tbl=tbl, spec=spec, kw=kw:
                ek.ext_lookup_bwd(tbl, idx, cw, gy, spec.n_rows, spec.n_levels, **kw))
    return out


def cuda_ms(fn):
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def device_ms(fn, iters=10):
    """Device ms a call: the sum of its CUDA kernels' times under
    torch.profiler."""
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
        t = getattr(ev, "self_device_time_total", None)
        total += ev.self_cuda_time_total if t is None else t
    return total / 1e3 / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_ext_kernels: no CUDA device available", file=sys.stderr)
        return 1
    from tcnn_tpu_torch.ops.cuda import _build
    from tcnn_tpu_torch.ops.cuda import ext_kernel as ek

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        variants = chosen_variants()
        libs = build_variants(pathlib.Path(tmp), variants)
        fns = shapes(dev, gen)
        ms = {k: {name: [] for name in libs} for k in fns}
        dev_ms = {k: {name: [] for name in libs} for k in fns}
        for _ in range(2):
            for name, lib in libs.items():
                _build._lib = lib
                for k, fn in fns.items():
                    ms[k][name].append(cuda_ms(fn))
                    dev_ms[k][name].append(device_ms(fn))
        _build._lib = None
    print(json.dumps({"card": smi, "checkout": str(ROOT), "iters": ITERS,
                      "ms": {k: {n: min(v) for n, v in t.items() if v} for k, t in ms.items()},
                      "device_ms": {k: {n: min(v) for n, v in t.items() if v}
                                    for k, t in dev_ms.items()},
                      "turns_ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
