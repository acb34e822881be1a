"""Readings that the limits of `correct` are set from, at a cell's own size
on the card: the program's numbers over many seeds (the lower readings),
the control's (the plain reference computed in float8 where the program
computes in bfloat16, put in the program's place) and each planted fault's
(the upper readings). Not run by the benchmark's runs.

    python3 portbench/calibrate.py --workload <cell> --seeds <first> \\
        --program 12 --control 3 --fault half:3 [--out FILE]

One JSON line per reading: {"cell", "kind", "seed", "numbers"}. Training
cells read the first steps and need no window; an answer cell renders each
view once, as many frames as a run compares.
"""

import argparse
import json
import pathlib
import sys
import time

BENCH_DIR = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR.parent))


def program_numbers(driver, cell, seed, device):
    import torch

    state = driver.setup(cell, seed, device)
    if driver.UNIT == "frame":
        for i in range(state.views.shape[0]):
            driver.unit(state, i)
    torch.cuda.synchronize(device)
    readings = driver.readings(state)
    del state
    torch.cuda.empty_cache()
    return driver.compare(readings, driver.reference(cell, seed, device, "f32"), cell)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, required=True, help="the first seed; each reading takes the next")
    ap.add_argument("--program", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", action="append", default=[], help="KIND:N")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from portbench import faults, harness, spec

    harness.check_card(1)
    device = torch.device("cuda", torch.cuda.current_device())
    cell = spec.load_cell(args.workload, BENCH_DIR)
    driver = spec.load_driver(cell)
    out = open(args.out, "a") if args.out else None
    seed = args.seeds

    def emit(kind, numbers, seconds):
        nonlocal seed
        line = json.dumps({"cell": cell.name, "kind": kind, "seed": seed, "seconds": seconds,
                           "numbers": numbers, "card": torch.cuda.get_device_name(device)})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        seed += 1

    plan = [("program", args.program), ("control", args.control)]
    plan += [(k.split(":")[0], int(k.split(":")[1])) for k in args.fault]
    for kind, n in plan:
        for _ in range(n):
            t0 = time.perf_counter()
            if kind == "program":
                numbers = program_numbers(driver, cell, seed, device)
            elif kind == "control":
                numbers = driver.compare(driver.reference(cell, seed, device, "fp8"),
                                         driver.reference(cell, seed, device, "f32"), cell)
            else:
                with faults.plant(cell.driver, kind):
                    numbers = program_numbers(driver, cell, seed, device)
            emit(kind, numbers, time.perf_counter() - t0)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
