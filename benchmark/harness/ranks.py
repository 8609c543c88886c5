"""Cells over several cards: one process a card.

Rank 0 runs in the harness's process.  :class:`Ranks` starts ranks 1 to
``world - 1``, each a fresh interpreter (``python -m
benchmark.harness.ranks``) with one intra-op thread; each finds the cell
by name as ``run.py`` does, loads the cell's driver file by path and calls
its ``rank_main(run, rank, world, init, extra, channel)``, with ``run`` on
card ``rank``.  The driver files are loaded by path, so this module is
the ranks' importable entry point.

A rank tells rank 0 what only it knows (its memory peak, its trace's
summary) through ``channel.put(kind, payload)``: a JSON line on a pipe of
its own.  Rank 0 reads each kind from every rank with
:meth:`Ranks.gather`, outside the measured window.  A rank's standard
output goes to standard error, so the harness's last line stays its own.

Nothing waits without a bound.  A watchdog thread in the harness's
process ends the run (every rank killed, exit code 3, the cause on
standard error) when a rank exits with an error, or when the ranks have
not all ended within ``deadline`` seconds of the start, wherever rank 0
is blocked (a collective whose peer is gone never returns; NCCL's own
timeout, which ``init_distributed_mode`` leaves at 10 minutes, is never
reached); every rank's Python stack is printed first.  A rank ends itself when the harness's process is gone (its
standard input, which the harness holds open, closes).
"""
from __future__ import annotations

import faulthandler
import json
import os
import socket
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import List

# the checkout that holds the benchmark and the port
ROOT = Path(__file__).resolve().parents[2]
EXIT_ABORTED = 3


def free_address() -> str:
    """A rendezvous address on this machine, at a port free just now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


class Channel:
    """A rank's messages to rank 0, one JSON line each."""

    def __init__(self, pipe):
        self.pipe = pipe

    def put(self, kind: str, payload) -> None:
        self.pipe.write(json.dumps([kind, payload]) + "\n")
        self.pipe.flush()


class Ranks:
    """Ranks 1 to ``world - 1`` of ``run``'s cell, started and watched.
    ``root`` is the checkout whose ``BENCHMARK.json`` names the cell."""

    def __init__(self, root: Path, run, world: int, init: str, extra: dict,
                 deadline: float):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "")
                           .split(os.pathsep) if p]))
        self._procs, self._pipes = [], []
        for r in range(1, world):
            read, write = os.pipe()
            spec = dict(root=str(root), workload=run.cell.name,
                        seed=run.seed, seconds=run.seconds, trace=run.trace,
                        device=run.device.type, rank=r, world=world,
                        init=init, extra=extra, fd=write,
                        deadline=deadline)
            self._procs.append(subprocess.Popen(
                [sys.executable, "-m", "benchmark.harness.ranks",
                 json.dumps(spec)], stdin=subprocess.PIPE, stdout=2,
                pass_fds=(write,), env=env))
            os.close(write)
            self._pipes.append(os.fdopen(read, "r"))
        self._end = time.monotonic() + deadline
        self._finished = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        while not self._finished.wait(0.2):
            for r, p in enumerate(self._procs, start=1):
                if p.poll() not in (None, 0):
                    self.abort(f"rank {r} exited with code {p.returncode}")
            if time.monotonic() > self._end:
                faulthandler.dump_traceback(sys.stderr)
                self.abort("the ranks did not end within their deadline")

    def abort(self, why: str) -> None:
        """End the run from any thread: kill every rank, exit non-zero."""
        print(f"[bench] {why}; ending the run", file=sys.stderr, flush=True)
        for p in self._procs:
            p.kill()
        for p in self._procs:
            p.wait(5.0)
        os._exit(EXIT_ABORTED)

    def gather(self, kind: str) -> List[object]:
        """Every other rank's next message, in rank order; each has to be
        a ``kind``."""
        out = []
        for r, pipe in enumerate(self._pipes, start=1):
            line = pipe.readline()
            got, payload = json.loads(line) if line else (None, None)
            if got != kind:
                self.abort(f"rank {r} sent {got!r} where {kind!r} was due")
            out.append(payload)
        return out

    def finish(self, timeout: float = 60.0) -> None:
        """Wait for every rank's ``done`` and its exit; close the pipes."""
        self.gather("done")
        for r, p in enumerate(self._procs, start=1):
            try:
                code = p.wait(timeout)
            except subprocess.TimeoutExpired:
                code = None
            if code != 0:
                self.abort(f"rank {r} did not end cleanly (exit code "
                           f"{code})")
        self._finished.set()
        for p, pipe in zip(self._procs, self._pipes):
            pipe.close()
            p.stdin.close()


def _end_with_parent() -> None:
    while os.read(0, 4096):  # unbuffered: holds no lock at shutdown
        pass
    os._exit(EXIT_ABORTED)


def main(argv=None) -> int:
    """A rank other than 0: the cell's ``rank_main`` on card ``rank``; an
    error is printed and ends the process with exit code 1."""
    spec = json.loads((argv or sys.argv[1:])[0])
    rank = spec["rank"]
    try:
        threading.Thread(target=_end_with_parent, daemon=True).start()
        # where a rank stuck past the deadline is, before it is killed
        faulthandler.dump_traceback_later(max(1.0, spec["deadline"] - 5.0))
        import torch
        torch.set_num_threads(1)
        from benchmark.harness.cell import Run
        from benchmark.harness.spec import Bench
        bench = Bench(Path(spec["root"]))
        cell = bench.cell(spec["workload"])
        device = (torch.device("cuda", rank) if spec["device"] == "cuda"
                  else torch.device(spec["device"]))
        run = Run(cell=cell, seed=spec["seed"], seconds=spec["seconds"],
                  device=device, trace=spec["trace"])
        with os.fdopen(spec["fd"], "w") as pipe:
            bench.driver(cell).rank_main(run, rank, spec["world"],
                                         spec["init"], spec["extra"],
                                         Channel(pipe))
    except BaseException:
        print(f"[bench] rank {rank} failed:\n{traceback.format_exc()}",
              file=sys.stderr, flush=True)
        os._exit(1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
