#!/usr/bin/env python3
"""Time the cold build of the port's CUDA sources, one nvcc per source, all
of a directory started together (as ``tcnn_tpu_torch/ops/cuda/_build.py``
builds them), on a machine with the CUDA toolkit:

    python3 scripts/time_nvcc.py DIR [DIR ...]

For each DIR (e.g. ``tcnn_tpu_torch/csrc``, or the same directory of another
commit unpacked with ``git archive``) prints the wall time of the whole and
of each source, slowest first. Sources are compiled with the build's flags
into a temporary directory; nothing is linked.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tcnn_tpu_torch.ops.cuda import _build  # noqa: E402


def main() -> None:
    nvcc = _build._nvcc()
    for d in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            procs = {
                f.name: subprocess.Popen(
                    [nvcc, *_build.NVCC_FLAGS, "-c", "-o", f"{out}/{f.name}.o", str(f)],
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
                for f in sorted(pathlib.Path(d).glob("*.cu"))
            }
            done = {}
            while len(done) < len(procs):
                for name, proc in procs.items():
                    if name not in done and proc.poll() is not None:
                        done[name] = (time.perf_counter() - t0, proc.returncode)
                time.sleep(0.05)
            total = time.perf_counter() - t0
        print(d, "total", round(total, 1),
              {n: round(t, 1) for n, (t, _) in sorted(done.items(), key=lambda kv: -kv[1][0])},
              "failed:", [n for n, (_, rc) in done.items() if rc != 0], flush=True)


if __name__ == "__main__":
    main()
