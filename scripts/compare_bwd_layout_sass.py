#!/usr/bin/env python3
"""What removing K5's SPLIT = false code from csrc/mlp_bwd_common.cuh did
to K6 and K9 (csrc/fused_train.cuh), on one CUDA GPU:

    python3 scripts/compare_bwd_layout_sass.py PARENT_CHECKOUT

Builds copies of this checkout's kernel library with text edits made in a
temporary directory (as scripts/ablate_mlp_kernels.py builds its variants): "full" as it
is; "split-field" with `BwdLayout::split` put back (always 1); "template"
with `wgrad_layer` a template again; "both". Compares each copy's SASS of
every fused_train_kernel instantiation (cuobjdump) with the parent
checkout's library, and times K6 (config_hash, B = 2^18) and K9 (the SDF
config, B = 2^16) through every library in turns, three turns of 50
launches (their C interface is the parent's). Prints one JSON line per
variant and one with the times, beside the card's nvidia-smi name and
power limit.
"""

from __future__ import annotations

import collections
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

B = 1 << 18
ITERS = 50
_LAYOUT = [(rf"BwdLayout {v}\{{nt, in_w, width, n_hidden, out_w, ",
            f"BwdLayout {v}{{nt, in_w, width, n_hidden, out_w, 1, ") for v in ("L", "lay")]
SPLIT_FIELD = {
    "mlp_bwd_common.cuh": [
        (r"  int nt, in_w, width, n_hidden, out_w;", "  int nt, in_w, width, n_hidden, out_w, split;"),
        (r"return \(size_t\)2 \* nt \* ld_g\(\) \* 2;",
         "return (size_t)(split ? 2 : 1) * nt * ld_g() * 2;")],
    "fused_train.cu": _LAYOUT,
    "fused_ig.cu": _LAYOUT,
}
TEMPLATE = [(r"static __device__ void wgrad_layer\(",
             "template <bool SPLIT = true>\n__device__ void wgrad_layer(")]
VARIANTS = (
    ("full", {}),
    ("split-field", SPLIT_FIELD),
    ("template", {"mlp_bwd_common.cuh": TEMPLATE}),
    ("both", {**SPLIT_FIELD, "mlp_bwd_common.cuh": SPLIT_FIELD["mlp_bwd_common.cuh"] + TEMPLATE}),
)


def sass(lib) -> dict:
    """{fused_train_kernel instantiation: [instruction]} of a library."""
    out = subprocess.run(["cuobjdump", "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    cur, res = None, collections.defaultdict(list)
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1) if "fused_train_kernel" in m.group(1) else None
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if cur and m:
            res[cur].append(m.group(1))
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: compare_bwd_layout_sass.py PARENT_CHECKOUT (on a CUDA device)",
              file=sys.stderr)
        return 1
    import ablate_mlp_kernels as ab
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.ops.cuda import _build, train_kernel
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    parent = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
         "from tcnn_tpu_torch.ops.cuda import _build; print(_build.library()._name)"],
        cwd=sys.argv[1], capture_output=True, text=True, check=True).stdout.strip()
    ab.VARIANTS = VARIANTS
    sys.argv = sys.argv[:1]  # build every variant
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"parent": pathlib.Path(parent), **ab.build_variants(pathlib.Path(tmp))}
        base = sass(paths["parent"])
        for name, path in paths.items():
            if name != "parent":
                mine = sass(path)
                print(json.dumps({"variant": name, "sass_vs_parent": {
                    k: "identical" if base[k] == mine.get(k)
                    else f"differs ({len(base[k])} vs {len(mine.get(k, []))} instructions)"
                    for k in base}}), flush=True)
        libs = {}
        for name, path in paths.items():
            lib = ctypes.CDLL(str(path))
            lib.tcnn_error_string.argtypes = [ctypes.c_int]
            lib.tcnn_error_string.restype = ctypes.c_char_p
            libs[name] = lib
        gen = torch.Generator().manual_seed(1234)
        m = tt.create_from_config(2, 3, tt.load_config(str(ROOT / "data" / "config_hash.json")),
                                  seed=1234, device="cuda")
        tr, net = m.trainer, m.network
        p = tr.params.detach().clone()
        n = net.network.n_params
        p[n:] = (torch.rand(p.numel() - n, generator=gen) * 2 - 1).cuda()
        x = torch.rand(B, 2, generator=gen).cuda()
        t = torch.rand(B, 3, generator=gen).cuda()
        sm = tt.create_from_config(3, 1, sdf.CONFIG, seed=1234, device="cuda")
        sp = sm.trainer.params.detach().clone()
        n = sm.network.network.n_params
        sp[n:] = (torch.rand(sp.numel() - n, generator=gen) * 2 - 1).cuda()
        xs = torch.rand(1 << 16, 3, generator=gen).cuda()
        gy = torch.zeros((1 << 16, sm.network.network.padded_output_width), device="cuda")
        gy[:, 0] = 1.0
        fns = {"K6": lambda: train_kernel.fused_train_grads(net, tr.loss_fn, p, x, t, tr.loss_scale),
               "K9": lambda: train_kernel.fused_ig_grads(sm.network, sp, xs, gy)}
        ms = {k: {name: [] for name in libs} for k in fns}
        for _ in range(3):
            for name, lib in libs.items():
                _build._lib = lib
                for k, fn in fns.items():
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
        print(json.dumps({"card": smi, "turns_ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
