"""Run one cell of the port's benchmark on this machine's cards.

    python3 benchmark/run.py --workload seg-stream-b16 --seed 7 \\
        --seconds 20 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number of the correctness check
beside its limit, which also end standard error.  Exits non-zero, with no
result, when CUDA is missing or has fewer cards than the cell asks for,
when the port is not in this checkout, or when ``jax``, ``jaxlib``,
``flax`` or ``dino_tpu`` was imported.

The kernels build into ``benchmark/.build/`` of this checkout (nvcc runs
in a checkout's first run only).  PyTorch runs one intra-op thread.
``BENCH_RUN`` in the environment is ignored.
"""
import time

T0 = time.time()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD = HERE / ".build"
FORBIDDEN = ("jax", "jaxlib", "flax", "dino_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``dino_tpu_torch`` is not ``dino_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def setup_env() -> None:
    """Fixed cache directories inside the checkout, so that only a
    checkout's first run builds; the checkout's root on the import path."""
    os.environ["DINO_TPU_TORCH_BUILD_DIR"] = str(BUILD / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(BUILD / "nv_compute_cache")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    setup_env()

    from benchmark.harness.spec import Bench
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)

    import torch
    # one intra-op thread: the program's host work (staging frames, its
    # eager enqueue) runs on the calling thread, as in a serving process
    # sharing its host, and no parallel region waits on a descheduled
    # core
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"[bench] {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import dino_tpu_torch
    except ImportError as err:
        print(f"[bench] the port is not in this checkout: {err}",
              file=sys.stderr)
        return 2
    if not Path(dino_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        print(f"[bench] dino_tpu_torch loaded from "
              f"{dino_tpu_torch.__file__}, outside {ROOT}", file=sys.stderr)
        return 2

    from benchmark.harness.cell import run_cell
    line = run_cell(bench, args.workload, args.seed, args.seconds,
                    bool(args.trace), "cuda", T0)
    bad = forbidden_modules()
    if bad:
        print(f"[bench] forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in line["compared"].items():
        print(f"[compared] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
