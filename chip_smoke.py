#!/usr/bin/env python3
"""On-card smoke test of dino_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout; exits non-zero on any
failure (and before printing any result when there is no card).  Phases,
each printing JSON lines:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds the kernels of dino_tpu_torch/csrc at first use;
  3. kernels vs their plain PyTorch versions on the card, at the main
     path's shapes, each against its stated tolerance;
  4. main path: DINOSeg.predict / predict_batch on random ViT-S/8 weights
     (3 blocks, MLP head, 7 classes) at 240/480/960px in bf16 and fp32,
     with every kernel's launch count read before and after;
  5. timing at the 480px batch-3 shapes (CUDA events, median of 30):
     kernel, plain version, one PyTorch library call, and the card's bound;
     then the cli/bench line;
  6. the per-kernel summary line, the card line, and the final status line.
"""
import copy
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from dino_tpu_torch import DINOSeg
from dino_tpu_torch.cli import bench
from dino_tpu_torch.ops import _build
from dino_tpu_torch.ops.attention import attention_plain, flash_attention
from dino_tpu_torch.ops.fused_mlp import (fused_ln_mlp_residual,
                                          fused_ln_mlp_residual_plain)

# H100 SXM published peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12

SCALE = 64 ** -0.5
EPS = 1e-6
# flash tolerances: f32 as dino_tpu's own flash tests (tests/test_attention.py);
# bf16 allows a few bf16 ulps, since the kernel rounds P against the running
# max of each 64-key tile and the plain version against the row's final max
FLASH_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
LSE_ATOL = 1e-5
MARGIN = 1e-4   # fp32 top-2 log-prob gap below which argmax may flip
CPU_LOGP_ATOL = 1e-3  # card fp32 vs CPU fp32 log-probs, same weights


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def median_ms(fn, reps=30, warmup=3):
    """Median device time of one call of ``fn``, CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(flops, nbytes, dtype):
    """Least time the card could take: max(operations / peak rate, bytes /
    memory rate), in ms, and which of the two bounds it."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


def bf16_ulp(mag):
    mag = mag.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def mlp_err(out, ref, x):
    """(max abs error, max error in bf16 ulps, within tolerance) of the fused
    MLP.  Tolerance: 2 bf16 ulps at the scale of the residual add's operands,
    max(|x|, |ref|, |h|) with h = ref - x, plus one bf16 ulp of rms(h).  The
    second term is the absolute error floor of h: h sums 1,536 products of
    bf16-rounded GELU outputs, and a one-step change of one of those
    roundings moves h by the same amount however far h cancels toward 0."""
    out, ref, x = out.float(), ref.float(), x.float()
    h = ref - x
    scale = torch.maximum(torch.maximum(x.abs(), ref.abs()), h.abs())
    err = (out - ref).abs()
    floor = bf16_ulp(h.pow(2).mean().sqrt())
    ok = bool((err <= 2 * bf16_ulp(scale) + floor).all())
    return err.max().item(), (err / bf16_ulp(scale)).max().item(), ok


def flash_inputs(bh, n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(3 if bh == 18 else 1, 6, n, 64, generator=g,
                        device="cuda").to(dtype) for _ in range(3)]


def phase_kernels(block):
    """Each kernel vs its plain version; returns max errors at the main
    path's (480px batch 3) shapes."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = FLASH_TOL[dtype]
        for n in (37, 901, 3601, 14401):
            for bh in (6, 18):
                q, k, v = flash_inputs(bh, n, dtype, seed=n + bh)
                out, lse = flash_attention(q, k, v, SCALE, return_lse=True)
                out_only = flash_attention(q, k, v, SCALE)
                torch.cuda.synchronize()
                ref, ref_lse = attention_plain(q, k, v, SCALE)
                err = (out.float() - ref.float()).abs()
                tol = atol + rtol * ref.float().abs()
                rec = {"phase": "kernel_check", "kernel": "flash_attn_fwd",
                       "dtype": str(dtype).split(".")[1], "bh": bh, "n": n,
                       "max_abs_err": err.max().item(),
                       "lse_max_abs_err": (lse - ref_lse).abs().max().item(),
                       "tol": [atol, rtol, LSE_ATOL]}
                emit(rec)
                check(bool((err <= tol).all()), f"flash out {rec}")
                check(rec["lse_max_abs_err"] <= LSE_ATOL, f"flash lse {rec}")
                check(torch.equal(out, out_only), "flash out with/without lse")
                if dtype == torch.bfloat16 and n == 3601 and bh == 18:
                    errs["flash_attn_fwd"] = rec["max_abs_err"]
                del q, k, v, out, lse, out_only, ref, ref_lse, err, tol
    g = torch.Generator(device="cuda").manual_seed(1)
    for m in (10803, 1000):
        x = (torch.randn(m, 384, generator=g, device="cuda") * 0.5
             ).to(torch.bfloat16)
        with torch.no_grad():
            out = fused_ln_mlp_residual(block.norm2, block.mlp, x, EPS)
            torch.cuda.synchronize()
            ref = fused_ln_mlp_residual_plain(block.norm2, block.mlp, x, EPS)
        max_err, ulps, ok = mlp_err(out, ref, x)
        rec = {"phase": "kernel_check", "kernel": "fused_ln_mlp", "m": m,
               "max_abs_err": max_err, "max_err_bf16_ulps": ulps,
               "tol": "2 bf16 ulps of max(|x|,|ref|,|h|) + 1 ulp of rms(h)"}
        emit(rec)
        check(ok, f"fused MLP {rec}")
        if m == 10803:
            errs["fused_ln_mlp"] = max_err
    return errs


def counts():
    return (flash_attention.launches, fused_ln_mlp_residual.launches)


def phase_main_path(model, frame, frames3):
    """predict / predict_batch through the public API; returns the launch
    counts of the whole run and per bf16 batch-3 predict."""
    flash_attention.launches = 0
    fused_ln_mlp_residual.launches = 0
    per_call = {}
    for prec in ("bf16", "fp32"):
        for res in (240, 480, 960):
            model.set_resolution(res)
            before = counts()
            t0 = time.perf_counter()
            out = model.predict(frame, precision=prec)
            dt = time.perf_counter() - t0
            d_flash, d_mlp = (a - b for a, b in zip(counts(), before))
            emit({"phase": "main_path", "call": "predict", "precision": prec,
                  "res": res, "shape": list(out.shape), "dtype": str(out.dtype),
                  "max_label": int(out.max()), "flash_launches": d_flash,
                  "fused_mlp_launches": d_mlp, "host_s": dt})
            check(out.shape == (480, 480) and out.dtype == np.int32,
                  "predict output shape/dtype")
            check(0 <= out.min() and out.max() < 7, "labels out of range")
            check(d_flash == 3, f"{d_flash} flash launches (want 3)")
            check(d_mlp == (3 if prec == "bf16" else 0),
                  f"{d_mlp} fused-MLP launches in {prec}")
    model.set_resolution(480)
    for prec in ("bf16", "fp32"):
        before = counts()
        out = model.predict_batch(frames3, precision=prec)
        per_call[prec] = [a - b for a, b in zip(counts(), before)]
        check(out.shape == (3, 480, 480) and out.dtype == np.int32,
              "predict_batch output")
        if prec == "fp32":
            imgs = torch.from_numpy(frames3).cuda()
            logp = model.log_probs(imgs, precision="fp32").cpu()
            top2 = torch.topk(logp, 2, dim=-1).values
            near = (top2[:, 0] - top2[:, 1] < MARGIN).reshape(3, 60, 60)
            flips = 0
            for i in range(3):
                single = torch.from_numpy(model.predict(frames3[i],
                                                        precision="fp32"))
                diff = (single != torch.from_numpy(out[i]))[::8, ::8]
                check(not bool((diff & ~near[i]).any()),
                      "predict_batch != predict away from near ties")
                flips += int(diff.sum())
            emit({"phase": "main_path", "call": "predict_batch vs predict",
                  "precision": "fp32", "patches_differing": flips,
                  "near_tie_patches": int(near.sum())})
        emit({"phase": "main_path", "call": "predict_batch", "batch": 3,
              "res": 480, "precision": prec,
              "flash_launches": per_call[prec][0],
              "fused_mlp_launches": per_call[prec][1]})
    total = counts()
    emit({"phase": "main_path", "total_flash_launches": total[0],
          "total_fused_mlp_launches": total[1]})
    check(total[0] > 0 and total[1] > 0, "a kernel was never launched")
    return {"flash_attn_fwd": total[0], "fused_ln_mlp": total[1]}, per_call


def phase_cpu_reference(model, frame):
    """Card fp32 vs CPU fp32 log-probs at 240px, same port weights."""
    cpu = DINOSeg(head="mlp", n_blocks=3, n_classes=7, precision="fp32",
                  random_init=True, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in
                         model.model.state_dict().items()})
    cpu.set_resolution(240)
    model.set_resolution(240)
    img = torch.from_numpy(frame[None])
    card = model.log_probs(img.cuda(), precision="fp32").cpu()
    ref = cpu.log_probs(img)
    diff = (card - ref).abs().max().item()
    emit({"phase": "cpu_reference", "res": 240,
          "logp_max_abs_diff_card_vs_cpu_fp32": diff, "tol": CPU_LOGP_ATOL,
          "finite": bool(torch.isfinite(card).all())})
    check(bool(torch.isfinite(card).all()), "non-finite log-probs")
    check(diff <= CPU_LOGP_ATOL, "card fp32 log-probs disagree with the CPU")


def phase_timing(block, per_call):
    """Per kernel at the 480px batch-3 shapes."""
    rows = {}
    q, k, v = flash_inputs(18, 3601, torch.bfloat16, seed=7)
    b, nh, n, hd = q.shape
    flops = 4 * n * n * hd * b * nh
    nbytes = 4 * b * nh * n * hd * q.element_size()
    bnd, by = bound_ms(flops, nbytes, torch.bfloat16)
    rows["flash_attn_fwd"] = {
        "ms": median_ms(lambda: flash_attention(q, k, v, SCALE)),
        "plain_ms": median_ms(lambda: attention_plain(q, k, v, SCALE)),
        "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=SCALE)),
        "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes,
        "launches_per_predict": per_call["bf16"][0]}
    # the kernel's own inputs: bf16 weights (the wrapper's casts of the f32
    # masters are then no-ops and stay out of the timed window)
    block = copy.deepcopy(block)
    for lin in (block.mlp.fc1, block.mlp.fc2):
        lin.weight.data = lin.weight.data.to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(2)
    m, d = 3 * 3601, 384
    h = block.mlp.fc1.weight.shape[0]
    x = (torch.randn(m, d, generator=g, device="cuda") * 0.5
         ).to(torch.bfloat16)
    flops = 4 * m * d * h
    nbytes = 2 * m * d * 2 + 2 * d * h * 2 + (h + 3 * d) * 4
    bnd, by = bound_ms(flops, nbytes, torch.bfloat16)
    with torch.no_grad():
        rows["fused_ln_mlp"] = {
            "ms": median_ms(lambda: fused_ln_mlp_residual(
                block.norm2, block.mlp, x, EPS)),
            "plain_ms": median_ms(lambda: fused_ln_mlp_residual_plain(
                block.norm2, block.mlp, x, EPS)),
            "library_ms": None,
            "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes,
            "launches_per_predict": per_call["bf16"][1]}
    for name, row in rows.items():
        emit(dict({"phase": "timing", "kernel": name, "shape": "480px batch 3",
                   "kernel_ms": row["ms"]}, **row))
    return rows


KERNELS = {
    "flash_attn_fwd": dict(
        source="dino_tpu_torch/csrc/flash_attn_fwd.cu",
        replaces="dino_tpu/ops/attention.py:90", tpu_kernel="_flash_kernel"),
    "fused_ln_mlp": dict(
        source="dino_tpu_torch/csrc/fused_ln_mlp.cu",
        replaces="dino_tpu/ops/fused_mlp.py:38", tpu_kernel="_kernel"),
}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on "
                         "the card")
    card = bench.card_name_and_power_limit()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds})
    print(_build.build_log, file=sys.stderr)

    model = DINOSeg(head="mlp", n_blocks=3, n_classes=7, precision="bf16",
                    random_init=True, seed=0)
    block = model.model.dino.blocks[0]
    errs = phase_kernels(block)

    rs = np.random.RandomState(0)
    frame = rs.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    frames3 = rs.randint(0, 256, (3, 480, 640, 3)).astype(np.uint8)
    launches, per_call = phase_main_path(model, frame, frames3)
    phase_cpu_reference(model, frame)
    rows = phase_timing(block, per_call)
    emit(dict({"phase": "bench"}, **bench.run()))

    emit({"kernels": [
        dict(name=name, route="cuda", launches=launches[name],
             max_abs_err=errs[name], max_err=errs[name],
             ms=rows[name]["ms"],
             plain_ms=rows[name]["plain_ms"],
             bound_ms=rows[name]["bound_ms"], bound_by=rows[name]["bound_by"],
             library_ms=rows[name]["library_ms"], **KERNELS[name])
        for name in KERNELS]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
