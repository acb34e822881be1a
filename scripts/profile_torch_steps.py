#!/usr/bin/env python3
"""Where a training step of tcnn_tpu_torch spends its time on one CUDA GPU.

    python3 scripts/profile_torch_steps.py [encoding_otype ...]

Profiles, with torch.profiler (CPU and CUDA activity), a short steady window
of each step after a warm-up:
  - the SDF step of tcnn_tpu_torch.samples.learn_a_sdf (B = 2^16, 1024
    eikonal points) with each encoding named (HashGrid, PPNG1, PPNG2,
    PPNG3; default HashGrid). HashGrid: the data term (K1 K2 K5 K4), the
    fused first order of the eikonal term (K3 K9) and its second order (K1
    K7 K8 and the matmul chain's double backward), then Adam. PPNG: the
    encoding's gathers (K10 K11, or K12 K13) with the torch combine, K2 K5
    for the data term, the matmul chain for the eikonal term, then Adam;
  - with no argument or with "config_hash", `Trainer.training_step` on
    data/config_hash.json at B = 2^18, on the fused route (K6) and the
    composed route (K1 K2 K5 K4); with "reference", the same at the
    reference's default hash grid (log2_hashmap_size 19, per_level_scale
    2.0: 5,592,320 rows), the image sample's step.
For each it prints one JSON line: wall ms per step (host clock around
synchronised steps, without the profiler: `utils.profiling.StepTimer`),
device ms per step (the sum of the CUDA kernels' times under the profiler,
`utils.profiling.trace`, whose trace files go to a temporary directory),
the device's busy share of the profiled wall time, the number of kernel
launches per step, and the kernels and the operators that take the most
device time. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

WARMUP = 10
STEPS = 20


def timed(step) -> float:
    """Wall ms a step over STEPS steps (the timer waits for the last)."""
    import torch
    from tcnn_tpu_torch.utils.profiling import StepTimer

    torch.cuda.synchronize()
    timer = StepTimer(1)
    for _ in range(STEPS):
        timer.step(step())
    return timer.seconds() * 1e3 / STEPS


def profile(name, step, smi):
    import torch
    from tcnn_tpu_torch.utils.profiling import trace

    for _ in range(WARMUP):
        step()
    wall_ms = timed(step)
    with tempfile.TemporaryDirectory() as logdir, trace(logdir) as prof:
        prof_wall_ms = timed(step)
    kernels = {}
    launches = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time_total > 0:
            key = ev.name[:80]  # the printed key: names that share it add up
            kernels[key] = kernels.get(key, 0.0) + ev.device_time_total / 1e3
            launches += 1
    device_ms = sum(kernels.values()) / STEPS
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    # the operators (aten ops, autograd Functions) whose own kernels take the most device time
    ops = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                  if e.self_device_time_total > 0), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "step": name, "card": smi, "wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
        "device_ms": device_ms, "device_busy": device_ms / prof_wall_ms if prof_wall_ms else 0.0,
        "kernel_launches_per_step": launches / STEPS,
        "top_kernels_ms_per_step": {k: v / STEPS for k, v in top},
        "top_ops_ms_per_step": {k[:80]: v / STEPS for k, v in ops},
    }), flush=True)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_steps: no CUDA device available", file=sys.stderr)
        return 1
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf
    from tcnn_tpu_torch.utils.image import sample_image, synthetic_image

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    image_grids = {"config_hash": {}, "reference": {"log2_hashmap_size": 19, "per_level_scale": 2.0}}
    names = argv[1:] or ["HashGrid", "config_hash"]
    for otype in (n for n in names if n not in image_grids):
        m = tt.create_from_config(3, 1, sdf.config(otype), device=dev)
        xs = torch.rand(sdf.BATCH, 3, generator=gen, device=dev)
        profile(f"sdf train_step {otype} B=2^16", lambda: sdf.train_step(m.trainer, xs), smi)

    image = synthetic_image(1024, 1024, device=dev)
    x = torch.rand(1 << 18, 2, generator=gen, device=dev)
    t = sample_image(image, x)
    for name in (n for n in names if n in image_grids):
        cfg = tt.load_config(str(ROOT / "data" / "config_hash.json"))
        cfg["encoding"].update(image_grids[name])
        m = tt.create_from_config(2, 3, cfg, device=dev)
        for route, flag in (("fused", None), ("composed", False)):
            m.trainer.use_fused_train_kernel = flag
            profile(f"{name} training_step {route} B=2^18",
                    lambda: m.trainer.training_step(x, t), smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
