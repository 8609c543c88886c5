"""The readings that a cell's correctness limits are set from, in one
process on this machine's card.

    python3 benchmark/readings.py --workload seg-stream-b16 \\
        --seeds 11 12 13 --seconds 3 --control-seeds 11 12 13 \\
        --fault altered_answer --fault-seeds 11 12 13

For every ``--seeds`` seed a run of the cell as ``run.py`` makes it (a
short window; the program's readings, the lower ones); for every
``--control-seeds`` seed the control (the reference in fp8 in the
program's place, ``control(run)`` of the cell's driver); for every
``--fault-seeds`` seed a run with the driver's named fault planted in the
program (``FAULTS``).  One JSON line a reading on standard output, and in
``--out`` if given.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.run import ROOT, forbidden_modules, setup_env  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    setup_env()
    import torch
    torch.set_num_threads(1)  # as run.py
    from benchmark.harness.cell import Run, run_cell
    from benchmark.harness.spec import Bench
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    driver = bench.driver(cell)
    device = torch.device(args.device)
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, numbers, **extra):
        line = json.dumps({"workload": args.workload, "kind": kind,
                           "seed": seed, "numbers": numbers, **extra})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def program(kind, seed):
        t = time.time()
        line = run_cell(bench, args.workload, seed, args.seconds, False,
                        device, t)
        emit(kind, seed, {k: v["value"] for k, v in line["compared"].items()},
             correct=line["correct"], metrics={
                 k: v["value"] for k, v in line["metrics"].items()},
             memory_peak_bytes=line["device"]["memory_peak_bytes"])
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

    for seed in args.seeds:
        program("program", seed)
    for seed in args.control_seeds:
        run = Run(cell=cell, seed=seed, seconds=0.0, device=device,
                  trace=False)
        emit("control", seed, driver.control(run))
    for name in args.fault:
        for seed in args.fault_seeds:
            with driver.FAULTS[name]():
                program(f"fault:{name}", seed)
    if out:
        out.close()
    bad = forbidden_modules()
    if bad:
        print(f"[readings] forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
