"""A closed-loop frame stream through ``DINOSeg.predict_stream``.

An endless iterator hands the port frames from the seeded pool in a
seeded order; the stream batches them (``batch_size``), enqueues batch
k + 1 before it reads batch k, and yields one 480x480 map a frame.  The
window counts the maps returned, in whole batches; the rate (the
traffic's ``rate_metric``, ``frames_per_s`` by default) is that count
over the window's seconds.  The check compares a seeded
sample of the window's maps with the reference.
"""
from __future__ import annotations

import time

import torch

from benchmark.harness import seg
from benchmark.harness.cell import Window


class Driver:
    def __init__(self, run):
        self.run = run
        self.tr = run.cell.traffic
        self.b = self.tr["batch_size"]
        self.consumed = 0

    def _frames(self):
        i = 0
        n = len(self.order)
        while True:
            yield self.pool[self.order[i % n]]
            i += 1

    def _take(self, n: int) -> None:
        for _ in range(n):
            next(self.stream)
        self.consumed += n

    def setup(self) -> None:
        self.model = seg.build_model(self.run)
        self.pool = seg.frame_pool(self.run)
        self.order = seg.frame_order(self.run)
        self.stream = self.model.predict_stream(
            self._frames(), batch_size=self.b,
            precision=self.run.cell.config["precision"])
        self._take(self.tr["warmup_batches"] * self.b)
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    def window(self) -> Window:
        sample = seg.Reservoir(self.tr["check_frames"], self.run.seed)
        n, b = 0, self.b
        wall = time.time()
        t0 = time.perf_counter()
        deadline = t0 + self.run.seconds
        for m in self.stream:
            sample.offer(self.consumed + n, m)
            n += 1
            if n % b == 0 and time.perf_counter() >= deadline:
                break
        seconds = time.perf_counter() - t0
        self.consumed += n
        self.sample = sample.items
        return Window(t_start=wall, seconds=seconds, attempted=n, failed=0,
                      work={"frames": n},
                      metrics={self.tr.get("rate_metric", "frames_per_s"):
                               n / seconds})

    def traced(self) -> dict:
        n = self.tr["trace_batches"] * self.b
        self._take(n)
        return {"iterations": self.tr["trace_batches"], "frames": n}

    def launches(self) -> dict:
        return seg.launches(self.run, self.b)

    def release(self) -> None:
        self.stream.close()
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
        del self.stream, self.model
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        return seg.check_maps(self.run, self.pool, self.order, self.sample)


def control(run) -> dict:
    return seg.control(run, Driver)


FAULTS = {"altered_answer": lambda: seg.altered_answers("dino_tpu_torch.api")}
