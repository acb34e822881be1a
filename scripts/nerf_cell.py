"""The NeRF cell `ngp_nerf.train` on the card, beyond what the benchmark's
runs do (needs a CUDA card; imports neither JAX nor the JAX package).

    python3 scripts/nerf_cell.py readings --seeds <first> [--program 12]
        [--control 12] [--fault KIND:N ...] [--out FILE]
    python3 scripts/nerf_cell.py batch --log2 18 --seed <n> [--seconds 10] [--trace 1]
    python3 scripts/nerf_cell.py host --log2 20 --seed <n> [--steps 20] [--out FILE]

`readings` prints one JSON line per reading, {"cell", "kind", "seed",
"numbers"}, the numbers that decide `correct`: the program's over seeds
(`portbench/calibrate.py`'s `program_numbers`), the control's (the
reference in float8 in the program's place) and each planted fault's, from
the cell's driver's own FAULTS (unchanged, half, opaque, no_ema), which
`portbench/faults.py` does not know. Each reading takes the next seed.

`batch` runs the cell once at 2^LOG2 samples a step (a mix override) and
prints its result line, as `portbench/run.py` does.

`host` sets the cell up at 2^LOG2 samples a step and prints where a step's
time goes: the device's ms a step with steps back to back (CUDA events);
the host's ms a step in each of the program's spans with the queue
emptied before each step (`profiling.recording()`, no profiler); and
torch.profiler's operators of three steps by host time, with the kernels
they launch (the table also to FILE).
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CELL = "ngp_nerf.train"


def readings(args, torch, spec, harness, calibrate):
    harness.check_card(1)
    device = torch.device("cuda", torch.cuda.current_device())
    cell = spec.load_cell(CELL)
    driver = spec.load_driver(cell)
    out = open(args.out, "a") if args.out else None
    plan = [("program", args.program), ("control", args.control)]
    plan += [(k.split(":")[0], int(k.split(":")[1])) for k in args.fault]
    seed = args.seeds
    for kind, n in plan:
        for _ in range(n):
            t0 = time.perf_counter()
            if kind == "program":
                numbers = calibrate.program_numbers(driver, cell, seed, device)
            elif kind == "control":
                numbers = driver.compare(driver.reference(cell, seed, device, "fp8"),
                                         driver.reference(cell, seed, device, "f32"), cell)
            else:
                with driver.FAULTS[kind]():
                    numbers = calibrate.program_numbers(driver, cell, seed, device)
            line = json.dumps({"cell": CELL, "kind": kind, "seed": seed,
                               "seconds": time.perf_counter() - t0, "numbers": numbers,
                               "card": torch.cuda.get_device_name(device)})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            seed += 1
    if out:
        out.close()


def batch(args, torch, spec, harness):
    cell = spec.load_cell(CELL, overrides={"batch": 1 << args.log2})
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), time.perf_counter())
    print(json.dumps(result), flush=True)


def host(args, torch, spec, harness):
    from tcnn_tpu_torch.utils import profiling

    harness.check_card(1)
    device = torch.device("cuda", torch.cuda.current_device())
    cell = spec.load_cell(CELL, overrides={"batch": 1 << args.log2})
    driver = spec.load_driver(cell)
    state = driver.setup(cell, args.seed, device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for i in range(args.steps):
        driver.unit(state, i)
    end.record()
    torch.cuda.synchronize(device)
    print(f"device: {start.elapsed_time(end) / args.steps:.4f} ms a step, back to back")
    profiling.reset_recorded()
    with profiling.recording():
        for i in range(args.steps):
            torch.cuda.synchronize(device)
            driver.unit(state, i)
    torch.cuda.synchronize(device)
    for name, row in profiling.recorded()["spans"].items():
        print(f"host: {name} {1e3 * row['total_s'] / args.steps:.4f} ms a step, "
              f"self {1e3 * row['self_s'] / args.steps:.4f}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            driver.unit(state, i)
        torch.cuda.synchronize(device)
    table = prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=60)
    print(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="command", required=True)
    r = sub.add_parser("readings")
    r.add_argument("--seeds", type=int, required=True)
    r.add_argument("--program", type=int, default=12)
    r.add_argument("--control", type=int, default=12)
    r.add_argument("--fault", action="append", default=[], help="KIND:N")
    r.add_argument("--out")
    b = sub.add_parser("batch")
    b.add_argument("--log2", type=int, required=True)
    b.add_argument("--seed", type=int, required=True)
    b.add_argument("--seconds", type=float, default=10.0)
    b.add_argument("--trace", type=int, choices=(0, 1), default=1)
    h = sub.add_parser("host")
    h.add_argument("--log2", type=int, default=20)
    h.add_argument("--seed", type=int, required=True)
    h.add_argument("--steps", type=int, default=20)
    h.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from portbench import calibrate, harness, spec

    torch.set_num_threads(1)
    if args.command == "readings":
        readings(args, torch, spec, harness, calibrate)
    elif args.command == "batch":
        batch(args, torch, spec, harness)
    else:
        host(args, torch, spec, harness)
    return 0


if __name__ == "__main__":
    sys.exit(main())
