"""Run one cell of the benchmark of tcnn_tpu_torch once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON object on the last line of standard output
and the numbers that decided `correct`, each beside its limit, as the last
lines of standard error. Exits 2 without a result when there is no CUDA
device or fewer than the cell needs, and 3 when the run loaded the JAX
package, JAX or the repository's JAX-era benchmarks.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Caches at fixed places inside the checkout, so only a checkout's first
# run builds: the port's nvcc build sits in build/tcnn_tpu_torch already.
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, spec

    # The card's work is enqueued by one host thread; idle intra-op threads
    # only contend with it for the host's shared cores (one thread: set-up
    # 6-7 s instead of 13-14 s on the SDF cell, the same window rates).
    torch.set_num_threads(1)
    cell = spec.load_cell(args.workload, BENCH_DIR)
    try:
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    except harness.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded {found}; no result", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in harness.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
