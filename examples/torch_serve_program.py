"""The port's fixed-shape predict program on the card, step by step.

Builds the bench config (ViT-S/8 cut to 3 blocks, MLP head, 7 classes,
random weights from a seed), captures its bf16 predict program for batch 3
of 480x640 frames at 480px, and prints one JSON line per step:

  * the capture's seconds and the labels against eager predict_batch;
  * the kernels torch.profiler sees in one replay;
  * host ms per batch (frames in, labels out) of eager predict_batch and of
    the program, in turns;
  * whether a fused Adam step bumps the parameters' version counters (it
    does not, which is why the program also counts optimizer steps), and
    the program's labels after the step;
  * an fp32 program at 240px, batch 1, and the export round trip.

    PYTHONPATH=. python3 examples/torch_serve_program.py
"""
import json
import os
import tempfile
import time

import numpy as np
import torch

from dino_tpu_torch import DINOSeg, export_predict, load_exported_predict
from dino_tpu_torch.serving import predict_program


def emit(obj):
    print(json.dumps(obj), flush=True)


def host_ms(fn, n=20):
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


def replay_kernels(fn):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[-2].split("::")[-1]: e.count
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and ("flash" in e.key or "fused" in e.key)}


def main():
    model = DINOSeg(head="mlp", n_blocks=3, n_classes=7, precision="bf16",
                    random_init=True, seed=0)
    frames = np.random.RandomState(0).randint(
        0, 256, (3, 480, 640, 3)).astype(np.uint8)
    eager = model.predict_batch(frames)
    t0 = time.perf_counter()
    program = predict_program(model, 3, (480, 640))
    emit({"capture_s": time.perf_counter() - t0,
          "same_bits": bool((program(frames) == eager).all())})
    emit({"kernels_per_replay": replay_kernels(lambda: program(frames))})
    ms = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        fn = (lambda: model.predict_batch(frames)) if name == "eager" else (
            lambda: program(frames))
        ms[name].append(host_ms(fn))
    emit({"host_ms_per_batch": ms})

    params = list(model.model.parameters())
    opt = torch.optim.Adam(params, lr=1e-3, fused=True)
    for p in params:
        p.grad = torch.randn_like(p) * 1e-2
    versions = [p._version for p in params]
    opt.step()
    emit({"fused_adam_bumps_versions": any(
              p._version != v for p, v in zip(params, versions)),
          "program_stale": program.stale(),
          "same_bits_after_step": bool(
              (program(frames) == model.predict_batch(frames)).all())})

    model.set_resolution(240)
    fp32 = predict_program(model, 1, (480, 640), "fp32")
    emit({"fp32_240px_same_bits": bool(
        (fp32(frames[:1]) == model.predict_batch(frames[:1],
                                                 precision="fp32")).all())})
    model.set_resolution(480)
    with tempfile.TemporaryDirectory() as tmp:
        path = export_predict(model, os.path.join(tmp, "p.dtts"),
                              batch_size=3, in_shape=(480, 640))
        emit({"export_same_bits": bool(
            (load_exported_predict(path)(frames)
             == model.predict_batch(frames)).all())})


if __name__ == "__main__":
    main()
