"""DINO pretraining over cards by data parallelism, as ``main_dino.py``
runs it under DDP: one process a card, each stepping the port's
``make_dino_train_step(..., dp_group=)`` on its slab of the global batch,
gradients, loss and the teacher's batch mean averaged over NCCL.

Rank 0 runs in the harness's process; it builds the kernels' library,
then spawns ranks 1 to world - 1 (``harness/ranks.py``), which run the
same phases through :func:`rank_main`.  Every rank builds its step as
``drivers/dino_pretrain.py`` does (its ``setup``, with the group passed
in) and draws the same weights from the seed.  Rank r's crops are images
[b r, b r + b) of each global batch, drawn on its own card from the seed
and tagged with the rank, so the check makes the whole batch again.

Set-up runs the first steps through the window's own call, reads what
the check needs (on rank 0), measures the ranks' weights against rank
0's (``rank_gap``: the largest |w_r - w_0| over max |w_0|), then times
``timing_steps`` steps; rank 0 fixes the window's steps from them, to
fill about ``--seconds``, and broadcasts that number.  The window carries
no traffic but the steps' own collectives: it starts after a barrier and
ends in a synchronize on every rank and a barrier.  The rate (the cell's
metric in images/s) is the global batch times the steps over rank 0's
seconds.  With
``--trace 1`` every rank profiles the same further steps; the device
numbers are averaged over the cards (``ranks_trace``), the idle gaps are
rank 0's.

The check follows the first steps over the global batch on rank 0's card
(``reference/dino.py``) and adds ``rank_gap``.  Faults are planted by name
in every rank (a spawned process does not inherit a patch).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
import traceback
from pathlib import Path
from unittest import mock

import torch
import torch.distributed as dist

from benchmark.drivers import dino_pretrain as one_card
from benchmark.harness.cell import Window, _profile
from benchmark.harness.images import make_images
from benchmark.harness.ranks import Ranks, free_address
from benchmark.harness.trace import TraceSummary
from benchmark.harness.weights import generator
from benchmark.reference import dino as ref_dino

# the ranks' whole run, start to exit, less the window (~40 s on four
# cards), is well under this
DEADLINE_S = 180.0
# the checkout this file is in, where the other ranks find the cell
ROOT = Path(__file__).resolve().parents[2]


class Driver(one_card.Driver):
    def __init__(self, run, rank: int = 0):
        super().__init__(run)
        self.rank = rank
        self.world = run.cell.chips
        self.ranks = None  # rank 0: the spawned ranks

    def _slab(self, i: int, r: int, device):
        """Rank r's crops of global batch i."""
        cfg = self.cfg
        gen = generator(self.run.seed, device, "crops", str(i), f"rank{r}")
        g, l = cfg["global_crops_size"], cfg["local_crops_size"]
        ng, nl = cfg["global_crops_number"], cfg["local_crops_number"]
        gl = make_images(gen, ng * self.b, g, g, device)
        lo = make_images(gen, nl * self.b, l, l, device)
        return gl.view(ng, self.b, g, g, 3), lo.view(nl, self.b, l, l, 3)

    def _batch(self, i: int):
        return self._slab(i, self.rank, self.run.device)

    def global_batch(self, i: int):
        """Global batch i on this rank's device: the ranks' slabs in order."""
        slabs = [self._slab(i, r, self.run.device) for r in range(self.world)]
        return (torch.cat([s[0] for s in slabs], dim=1),
                torch.cat([s[1] for s in slabs], dim=1))

    @contextlib.contextmanager
    def _guard(self):
        """On rank 0, an error while the other ranks live ends them all."""
        try:
            yield
        except BaseException:
            if self.ranks is None:
                raise
            self.ranks.abort(f"rank 0 failed:\n{traceback.format_exc()}")

    def _sync_all(self) -> None:
        """A synchronize on this rank, a barrier, a synchronize."""
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
            dist.barrier(device_ids=[torch.cuda.current_device()])
            torch.cuda.synchronize(self.run.device)
        else:
            dist.barrier()

    def setup(self, init: str | None = None) -> None:
        from dino_tpu_torch.parallel.dist import init_distributed_mode
        from dino_tpu_torch.train import dino_pretrain as dp
        cuda = self.run.device.type == "cuda"
        if self.rank == 0:
            if cuda:  # built here once, before the other ranks load it
                from dino_tpu_torch.ops import _build
                _build.library()
            init = free_address()
            fault = getattr(dp.make_dino_train_step, "planted", None)
            self.ranks = Ranks(ROOT, self.run, self.world, init,
                               {"fault": fault},
                               DEADLINE_S + self.run.seconds)
        with self._guard():
            init_distributed_mode("nccl" if cuda else "gloo", init,
                                  self.world, self.rank)
            make = functools.partial(dp.make_dino_train_step,
                                     dp_group=dist.group.WORLD)
            with mock.patch.object(dp, "make_dino_train_step", make):
                super().setup()
            self.rank_gap = self._rank_gap()
            self.n = self._window_steps()

    def _rank_gap(self) -> torch.Tensor:
        """max over ranks of max |w_r - w_0| / max |w_0|, the student's
        weights after the first steps (on every rank)."""
        mine = torch.cat([p.detach().reshape(-1)
                          for p in self.student.parameters()])
        w0 = mine.clone() if self.rank == 0 else torch.empty_like(mine)
        dist.broadcast(w0, 0)
        gap = ((mine - w0).abs().max() / w0.abs().max()).reshape(1)
        dist.all_reduce(gap, op=dist.ReduceOp.MAX)
        return gap

    def _window_steps(self) -> int:
        """The window's steps, from rank 0's time for ``timing_steps``."""
        k = self.tr["timing_steps"]
        self._sync_all()
        t0 = time.perf_counter()
        for _ in range(k):
            self._step()
        self._sync_all()
        per_step = (time.perf_counter() - t0) / k
        n = torch.tensor([max(1, round(self.run.seconds / per_step))],
                         device=self.run.device)
        dist.broadcast(n, 0)
        return int(n.item())

    def window(self) -> Window:
        with self._guard():
            self._sync_all()
            wall = time.time()
            t0 = time.perf_counter()
            losses = [self._step() for _ in range(self.n)]
            self._sync_all()
            seconds = time.perf_counter() - t0
        bad = int((~torch.isfinite(torch.stack(losses))).sum())
        images = self.world * self.b * self.n
        # the rate, under the cell's end-to-end metric of images a second
        rates = {m["name"]: images / seconds for m in self.run.cell.end_to_end
                 if m["unit"] == "images/s"}
        return Window(t_start=wall, seconds=seconds, attempted=self.n,
                      failed=bad, work={"steps": self.n, "images": images},
                      metrics=rates)

    def memory_peak(self, mine: int) -> int:
        """The peak of the fullest card (each rank's after its window)."""
        with self._guard():
            return max([mine] + self.ranks.gather("peak"))

    def traced(self) -> dict:
        with self._guard():
            info = super().traced()
        return {**info, "images": self.world * info["images"]}

    def ranks_trace(self, summary: TraceSummary | None
                    ) -> TraceSummary | None:
        """Rank 0's summary with its device numbers averaged over every
        rank's trace (busy, window, kernels, copies, collectives); the
        idle gaps stay rank 0's."""
        with self._guard():
            others = self.ranks.gather("trace")
        if summary is None or any(o is None for o in others):
            return summary
        every = [summary] + [TraceSummary(**o) for o in others]

        def mean(field):
            return sum(getattr(s, field) for s in every) / len(every)

        def mean_by_name(field):
            names = set().union(*(getattr(s, field) for s in every))
            return {k: sum(getattr(s, field).get(k, 0.0) for s in every)
                    / len(every) for k in names}
        return dataclasses.replace(
            summary, busy_s=mean("busy_s"), window_s=mean("window_s"),
            comm_s=mean("comm_s"), comm_exposed_s=mean("comm_exposed_s"),
            kernel_s=mean_by_name("kernel_s"), copy_s=mean_by_name("copy_s"))

    def release(self) -> None:
        with self._guard():
            self.rank_gap = float(self.rank_gap)
            super().release()
            # every rank leaves the group together: NCCL's teardown waits
            # for the peers
            dist.destroy_process_group()
            self.ranks.finish()

    def check(self) -> dict:
        """The first steps again in the reference over the global batches,
        compared as one card's are, and ``rank_gap``."""
        self.pool = [self.global_batch(i)
                     for i in range(self.tr["first_steps"])]
        return {**super().check(), "rank_gap": self.rank_gap}


def rank_main(run, rank: int, world: int, init: str, extra: dict,
              channel) -> None:
    """Rank ``rank``'s part of a run (``harness/ranks.py``): the phases
    rank 0 runs in the harness, in the same order, with the same fault."""
    fault = extra["fault"]
    with FAULTS[fault]() if fault else contextlib.nullcontext():
        drv = Driver(run, rank)
        drv.setup(init)
        drv.window()
        cuda = run.device.type == "cuda"
        channel.put("peak", torch.cuda.max_memory_allocated(run.device)
                    if cuda else 0)
        if run.trace:
            summary = _profile(drv, run.device)[0]
            channel.put("trace", None if summary is None
                        else dataclasses.asdict(summary))
        dist.destroy_process_group()
        channel.put("done", None)


def control(run) -> dict:
    """The control: the reference's first steps over the global batches
    with fp8 products in the program's place (``dino_pretrain.control``'s
    comparison)."""
    d = Driver(run)
    batches = [d.global_batch(i) for i in range(d.tr["first_steps"])]
    mb = d.tr["check_microbatch"]
    ref = ref_dino.run_steps(d.weights(), batches, d.cfg, mb)
    low = ref_dino.run_steps(d.weights(), batches, d.cfg, mb, fp8=True)
    prog = {"losses": low["losses"],
            "grad_norms": {k: float(torch.linalg.vector_norm(g))
                           for k, g in low["first_grads"].items()},
            "moves": low["moves"], "teacher_moves": low["teacher_moves"],
            "center": low["center"]}
    return one_card.compare_steps(prog, ref)


# the faults that wrap the step; ``no_allreduce`` builds it without the
# group instead
WRAPS = {"unchanged_state": one_card._unchanged,
         "half_batch": one_card._half_batch}


def _plant(name: str):
    """Every step built under this is faulty: ``unchanged_state`` returns
    the state as it found it, ``half_batch`` leaves out half of the rank's
    slab, ``no_allreduce`` steps each rank on its own gradient.  The
    factory carries the fault's name, which rank 0 hands to the other
    ranks."""
    from dino_tpu_torch.train import dino_pretrain as dp
    orig = dp.make_dino_train_step

    def make(*args, **kwargs):
        if name == "no_allreduce":
            return orig(*args, **{**kwargs, "dp_group": None})
        return WRAPS[name](orig(*args, **kwargs))
    make.planted = name
    return mock.patch.object(dp, "make_dino_train_step", make)


FAULTS = {name: functools.partial(_plant, name)
          for name in (*WRAPS, "no_allreduce")}
