#!/usr/bin/env python
"""Headline benchmark of the port on one CUDA card: frames/s of the full
predict path (uint8 480x640 camera frame -> resize -> normalize -> ViT-S/8
truncated to 3 blocks -> MLP head -> argmax -> 480x480 label map) at 480px,
batch 3, bf16, random weights from a seed.

Prints ONE JSON line with the keys of ``dino_tpu/cli/bench.py``.  Device
times come from CUDA events after ``torch.cuda.synchronize()``, with the
frames already on the card; the single-frame latency is host wall time and
includes the host<->device copies.  ``breakdown`` splits one batch's
device time by kernel (torch.profiler) and gives the device's idle share.

The secondary metric is ``dino_tpu/cli/bench.py``'s: ``unfrozen_train_fps``,
frames/s of the unfrozen finetune step (ViT-S/8 3 blocks + MLP head, 7
classes, 480x480 uint8 batch of 16 with labels from the seed, 8
microbatches, Adam 1e-5, bf16): one warm-up step, then 8 steps timed on the
host clock and synchronized.  ``train_breakdown`` is one step's device time
by kernel and the device's idle share in it.

    python -m dino_tpu_torch.cli.bench
"""
from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

from dino_tpu_torch.api import DINOSeg
from dino_tpu_torch.train.loop import (init_opt_state, make_optimizer,
                                       make_train_step)
from dino_tpu_torch.utils.device import resolve_device


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for card 0, as printed."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _event_ms(fn, n: int) -> float:
    """Mean device ms of ``fn`` over n back-to-back calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_breakdown(fn, n: int, span_ms: float, top: int = 8) -> dict:
    """Where the device time of one ``fn`` call goes: torch.profiler over n
    calls, the kernels' device time summed by name.  ``span_ms`` is the
    unprofiled device time of one call (CUDA events, first kernel to last),
    so the idle share is the part of that span no kernel ran in (one
    stream: kernels do not overlap)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    # the device's own events (kernels, copies, memsets); the CPU ops that
    # launched them carry the same time again and are left out
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / n)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.is_user_annotation),
                     key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in kernels)
    if busy == 0:  # the profiler saw no device activity: nothing to report
        return {"device_busy_ms": None, "device_idle_share": None,
                "kernels": []}
    return {"device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / span_ms),
            "kernels": [{"name": name[:100], "ms": ms, "share": ms / busy}
                        for name, ms in kernels[:top]]}


# the JAX bench's train recipe (dino_tpu/cli/bench.py:104-133)
TRAIN_BATCH, TRAIN_ACCUM_STEPS, TRAIN_TIMED_STEPS = 16, 8, 8


def run_train(res: int, precision: str, seed: int) -> dict:
    """The unfrozen finetune step's throughput and device breakdown."""
    batch = TRAIN_BATCH
    device = resolve_device(None)
    model = DINOSeg(head="mlp", n_blocks=3, n_classes=7, precision=precision,
                    random_init=True, seed=seed, device=device,
                    freeze_backbone=False)
    vit, head = model.model.dino, model.model.clf
    opt = make_optimizer("adam", 1e-5)
    opt_state = init_opt_state(opt, vit, head, freeze_backbone=False)
    step = make_train_step(model.cfg, "mlp", model.n_classes, opt,
                           freeze_backbone=False,
                           compute_dtype=(torch.bfloat16 if precision == "bf16"
                                          else None),
                           accum_steps=TRAIN_ACCUM_STEPS)
    rs = np.random.RandomState(seed)
    out_size = res // model.cfg.patch_size
    labels = torch.from_numpy(rs.randint(
        0, model.n_classes, (batch, out_size * out_size)).astype(np.int32)
    ).to(device)
    imgs = torch.from_numpy(rs.randint(0, 255, (batch, res, res, 3)).astype(
        np.uint8)).to(device)

    def one_step():
        return step(vit, head, opt_state, imgs, labels)

    one_step()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED_STEPS):
        loss, _ = one_step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1000 / TRAIN_TIMED_STEPS
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"train bench: non-finite loss {loss.item()}")
    return {"unfrozen_train_fps": batch * 1000.0 / step_ms,
            "train_step_ms": step_ms, "train_batch": batch,
            "train_accum_steps": TRAIN_ACCUM_STEPS,
            "train_breakdown": device_breakdown(one_step, 1, step_ms)}


def run(batch: int = 3, res: int = 480, precision: str = "bf16",
        iters: int = 0, seed: int = 0) -> dict:
    device = resolve_device(None)  # the card, or raise
    model = DINOSeg(head="mlp", n_blocks=3, n_classes=7, precision=precision,
                    random_init=True, seed=seed, device=device)
    model.set_resolution(res)
    rs = np.random.RandomState(seed)
    frames = torch.from_numpy(
        rs.randint(0, 255, (batch, 480, 640, 3)).astype(np.uint8)).to(device)
    n_iters = iters or max(20, 320 // batch)

    _event_ms(lambda: model.predict_device(frames), 3)  # warm up
    batch_ms = _event_ms(lambda: model.predict_device(frames), n_iters)
    fps = batch * 1000.0 / batch_ms
    breakdown = device_breakdown(lambda: model.predict_device(frames), 10,
                                 batch_ms)

    one = rs.randint(0, 255, (480, 640, 3)).astype(np.uint8)
    model.predict(one)
    lats = []
    for _ in range(20):
        t0 = time.perf_counter()
        model.predict(one)
        lats.append(time.perf_counter() - t0)
    p50_ms = float(np.percentile(lats, 50) * 1000)

    one_dev = torch.from_numpy(one[None]).to(device)
    p50_device_ms = float(np.median(
        [_event_ms(lambda: model.predict_device(one_dev), 10)
         for _ in range(5)]))

    base_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "..", "..", "bench_baseline.json")
    baseline_fps = baseline_train_fps = None
    if os.path.exists(base_path):
        with open(base_path) as f:
            base = json.load(f)
        baseline_fps = base.get("torch_cpu_fps")
        baseline_train_fps = base.get("torch_cpu_train_fps")
    tr = run_train(res, precision, seed)
    train_fps = tr["unfrozen_train_fps"]
    return {
        "metric": "frames_per_sec_480px_vit_s8_3block_mlp",
        "value": fps,
        "unit": "frames/s/card",
        "vs_baseline": fps / baseline_fps if baseline_fps else None,
        "p50_predict_latency_ms": p50_ms,
        "p50_device_ms": p50_device_ms,
        "batch_device_ms": batch_ms,
        "breakdown": breakdown,
        "unfrozen_train_fps": train_fps,
        "train_vs_baseline": (train_fps / baseline_train_fps
                              if baseline_train_fps else None),
        "train_accum_steps": tr["train_accum_steps"],
        "train_batch": tr["train_batch"],
        "train_step_ms": tr["train_step_ms"],
        "train_breakdown": tr["train_breakdown"],
        "batch": batch,
        "precision": precision,
        "backend": "cuda",
        "device": torch.cuda.get_device_name(device),
        "card": card_name_and_power_limit(),
    }


def main():
    print(json.dumps(run(
        batch=int(os.environ.get("BENCH_BATCH", "3")),
        precision=os.environ.get("BENCH_PRECISION", "bf16"),
        iters=int(os.environ.get("BENCH_ITERS", "0")))))


if __name__ == "__main__":
    main()
