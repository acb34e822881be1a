#!/usr/bin/env python3
"""Where K6's time goes: time the fused train step (K6, ``csrc/fused_train.cu``)
through copies of the kernel library in which the step loses one phase
more each time, on one CUDA GPU:

    python3 scripts/ablate_k6_phases.py

Variants of ``fused_train.cuh``'s train step, each built from this
checkout's sources with text edits made in a temporary directory (the
package's own sources and library are not touched):
  full       the step as it is;
  -scatter   step 5, the table-gradient scatter, removed;
  -backward  also step 4, the MLP backward and its weight-gradient partials;
  -forward   also steps 2-3, the MLP forward and the loss: the gather, the
             weights' load and the fixed-order reduce are left.
So the scatter takes full - (-scatter), the backward (-scatter) -
(-backward), the forward and loss (-backward) - (-forward). K6 is timed
with CUDA events (50 launches, best of two turns, variants in turns) at
B = 2^18 on data/config_hash.json and at the reference's default hash grid
(log2_hashmap_size 19, per_level_scale 2.0), the table redrawn from
U(-1, 1). Prints one JSON line per configuration with the card's
nvidia-smi name and power limit. Run it from the root of any checkout of
the port (the script reads the package beside it).
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
    ("-backward", [(r"mlp_backward_chain<true>\((?:.|\n)*?\}\);", "nullptr;")]),
    ("-forward", [(r"mlp_forward_keep\(m, L, smem, sw, sc\);", ";"),
                  (r"for \(int e = lane; e < 16 \* out_w; e \+= 32\)",
                   "for (int e = lane; e < 0; e += 32)")]),
)


def build_variants(tmp: pathlib.Path) -> dict:
    """{variant: path of its library}: every source but fused_train.cu
    compiled once, fused_train.cu once per variant, all at once."""
    from tcnn_tpu_torch.ops.cuda import _build

    nvcc = _build._nvcc()
    src = tmp / "src"
    shutil.copytree(_build.CSRC, src)
    header = (src / "fused_train.cuh").read_text()
    base = [p for p in sorted(src.glob("*.cu")) if p.name != "fused_train.cu"]
    cmds = [[nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(tmp / f"{p.stem}.o"), str(p)] for p in base]
    text = header
    for name, edits in VARIANTS:
        for pattern, repl in edits:
            text, n = re.subn(pattern, repl, text)
            if n != 1:
                raise RuntimeError(f"{name}: {pattern!r} matched {n} times")
        vdir = tmp / f"v{len(cmds)}"
        shutil.copytree(src, vdir)
        (vdir / "fused_train.cuh").write_text(text)
        cmds.append([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(vdir / "fused_train.o"),
                     str(vdir / "fused_train.cu")])
    _build._run_all(cmds)
    objs = [str(tmp / f"{p.stem}.o") for p in base]
    libs, links = {}, []
    for (name, _), cmd in zip(VARIANTS, cmds[len(base):]):
        lib = tmp / f"lib{len(libs)}.so"
        links.append([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib), *objs, cmd[-2]])
        libs[name] = lib
    _build._run_all(links)
    return libs


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
        for name, path in build_variants(pathlib.Path(tmp)).items():
            lib = ctypes.CDLL(str(path))
            lib.tcnn_error_string.argtypes = [ctypes.c_int]
            lib.tcnn_error_string.restype = ctypes.c_char_p
            libs[name] = lib
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
            for _ in range(2):
                for name, lib in libs.items():
                    _build._lib = lib
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
            best = {name: min(v) for name, v in ms.items()}
            names = [n for n, _ in VARIANTS]
            phases = {"scatter": best["full"] - best["-scatter"],
                      "mlp_backward": best["-scatter"] - best["-backward"],
                      "mlp_forward_and_loss": best["-backward"] - best["-forward"],
                      "gather_and_rest": best["-forward"]}
            print(json.dumps({"config": label, "B": B, "card": smi, "checkout": str(ROOT),
                              "k6_ms": {n: best[n] for n in names}, "turns_ms": ms,
                              "phases_ms": phases}), flush=True)
        _build._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
