#!/usr/bin/env python3
"""Times of the MLP kernels at the shapes their paths launch, on one CUDA
GPU, through the package's public wrappers only:

    python3 scripts/time_mlp_kernels.py [CHECKOUT] [--ptxas]

CHECKOUT (default: the checkout holding this script) is the root of the
checkout whose `tcnn_tpu_torch` is built and timed, so the same file times
another commit's kernels, for example a parent commit unpacked with
`git archive`: run parent, this, this, parent in one run on one card and
compare within it. Each checkout builds its own kernel library.

Timed with CUDA events (50 launches a turn, best of two turns), and again
under torch.profiler for the device time of each call's kernels (10
launches; `device_ms`, with the kernels by name), random params from one
seed, the grid table redrawn from U(-1, 1):
  data/config_hash.json, B = 2^18: K1 (grid_encode), K2 (mlp_forward), K1
    + K2 (the two in sequence), K3 (fused_forward_prepared),
    `trainer.inference`, K5 (mlp_backward, random bf16 cotangent), K6
    (fused_train_grads); K3 also at 2^20 (the image sample's render chunk);
    K3 and K6 also at the reference's default grid (log2_hashmap_size 19,
    per_level_scale 2.0), B = 2^18;
  samples/learn_a_sdf.CONFIG: K3 and K9 (fused_ig_grads) at the eikonal
    term's 1024 points, K5 at B = 2^16 (the data term), K9 at 2^16 and 2^18;
  K5 at width 128 with 5 hidden layers (in 32, out 16), B = 2^18.
With --ptxas, also `nvcc -Xptxas -v` of the checkout's fused_infer.cu,
mlp_bwd.cu and K6's and K9's sources (fused_train*.cu, fused_ig*.cu) at
the build's flags, all at once: each K3, K5, K6 and K9 instantiation's
registers and spills. Prints one JSON line with the card's `nvidia-smi`
name and power limit. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import tempfile

ARGS = [a for a in sys.argv[1:] if a != "--ptxas"]
ROOT = pathlib.Path(ARGS[0] if ARGS else __file__).resolve()
if ROOT.is_file():
    ROOT = ROOT.parents[1]
sys.path.insert(0, str(ROOT))

SEED = 1234
ITERS = 50


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


def randomized(model, gen):
    """The model's trainer with the encoding table redrawn from U(-1, 1)."""
    import torch

    tr = model.trainer
    p = tr.params.detach().cpu().clone()
    n_net = model.network.network.n_params
    p[n_net:] = torch.rand(p.numel() - n_net, generator=gen) * 2 - 1
    tr.set_params(p)
    return tr


KERNELS = ("fused_infer_kernel", "mlp_bwd_kernel", "fused_train_kernel")


def ptxas_readings():
    """{kernel instantiation: ptxas's 'Used ...' and spill lines} of K3, K5,
    K6 and K9."""
    from tcnn_tpu_torch.ops.cuda import _build

    out = {}
    sources = [_build.CSRC / "fused_infer.cu", _build.CSRC / "mlp_bwd.cu",
               *sorted(_build.CSRC.glob("fused_train*.cu")),
               *sorted(_build.CSRC.glob("fused_ig*.cu"))]
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                                   "-o", f"{tmp}/{src.name}.o", str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src in sources]
        for proc in procs:
            text = proc.communicate()[0]
            name = None
            for line in text.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    name = m.group(1)
                elif name and any(k in name for k in KERNELS):
                    if "Used" in line or "spill" in line:
                        out.setdefault(name, []).append(line.split("info    :")[-1].strip())
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_mlp_kernels: no CUDA device available", file=sys.stderr)
        return 1
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.cuda import grid_kernel, mlp_kernel, train_kernel
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    ms, dev_ms = {}, {}

    def timed(key, fn):
        ms[key] = cuda_ms(fn)
        dev_ms[key] = device_ms(fn)

    cfg = tt.load_config(str(ROOT / "data" / "config_hash.json"))
    for tag, enc_over in (("", {}), (" T=2^19", {"log2_hashmap_size": 19,
                                                  "per_level_scale": 2.0})):
        c = json.loads(json.dumps(cfg))
        c["encoding"].update(enc_over)
        model = tt.create_from_config(2, 3, c, seed=SEED, device=dev)
        tr, net = randomized(model, gen), model.network
        prep = train_kernel.prepare_forward(net, tr.params)
        plan, dims = prep.plan, prep.dims
        enc_w = net.encoding.padded_output_width
        x = torch.rand(1 << 18, 2, generator=gen).to(dev)
        t = torch.rand(1 << 18, 3, generator=gen).to(dev)
        timed("K3" + tag, lambda: train_kernel.fused_forward_prepared(prep, x))
        if tag:
            timed("K6" + tag, lambda: train_kernel.fused_train_grads(net, tr.loss_fn, tr.params,
                                                                     x, t, tr.loss_scale))
            continue
        enc = grid_kernel.grid_encode(plan, prep.table, x, enc_w, plan.n_levels)
        gy = torch.randn(1 << 18, dims.out_w, generator=gen).to(torch.bfloat16).to(dev)
        timed("K1", lambda: grid_kernel.grid_encode(plan, prep.table, x, enc_w,
                                                           plan.n_levels))
        timed("K2", lambda: mlp_kernel.mlp_forward(dims, prep.weights, enc))
        timed("K1 + K2", lambda: mlp_kernel.mlp_forward(
            dims, prep.weights, grid_kernel.grid_encode(plan, prep.table, x, enc_w,
                                                        plan.n_levels)))
        timed("trainer.inference", lambda: tr.inference(x))
        timed("K5", lambda: mlp_kernel.mlp_backward(dims, prep.weights, enc, gy))
        timed("K6", lambda: train_kernel.fused_train_grads(net, tr.loss_fn, tr.params, x,
                                                                  t, tr.loss_scale))
        x20 = torch.rand(1 << 20, 2, generator=gen).to(dev)
        timed("K3 B=2^20", lambda: train_kernel.fused_forward_prepared(prep, x20))
        dims128 = mlp_kernel.MlpDims(enc_w, 128, 5, 16, Activation.ReLU, Activation.NONE)
        w128 = (torch.rand(dims128.n_weights, generator=gen) * 0.2 - 0.1).to(torch.bfloat16)
        w128 = w128.to(dev)
        timed("K5 128x5", lambda: mlp_kernel.mlp_backward(dims128, w128, enc, gy))

    sm = tt.create_from_config(3, 1, sdf.CONFIG, seed=SEED, device=dev)
    str_, snet = randomized(sm, gen), sm.network
    sprep = train_kernel.prepare_forward(snet, str_.params)
    for B in (sdf.N_EIKONAL, 1 << 16, 1 << 18):
        x = torch.rand(B, 3, generator=gen).to(dev)
        gy_out = torch.zeros((B, snet.network.padded_output_width), device=dev)
        gy_out[:, 0] = 1.0
        timed(f"K9 SDF B={B}", lambda: train_kernel.fused_ig_grads(snet, str_.params, x,
                                                                          gy_out))
        if B == sdf.N_EIKONAL:
            timed(f"K3 SDF B={B}", lambda: train_kernel.fused_forward_prepared(sprep, x))
        elif B == 1 << 16:
            enc = grid_kernel.grid_encode(sprep.plan, sprep.table, x,
                                          snet.encoding.padded_output_width,
                                          sprep.plan.n_levels)
            gy = torch.randn(B, sprep.dims.out_w, generator=gen).to(torch.bfloat16).to(dev)
            timed(f"K5 SDF B={B}", lambda: mlp_kernel.mlp_backward(
                sprep.dims, sprep.weights, enc, gy))

    print(json.dumps({"checkout": str(ROOT), "card": smi, "ms": ms, "device_ms": dev_ms,
                      "ptxas": ptxas_readings() if "--ptxas" in sys.argv else None}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
