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
  5. train path: make_train_step on the same model config, unfrozen bf16
     at 480px (batch 16, 8 microbatches, 3 steps), frozen bf16 (1 step) and
     unfrozen fp32 at 240px (batch 2, 1 step), with the launch counts read
     around every step; the fp32 step is repeated on the CPU from the same
     weights and batch and its loss and gradients compared;
  6. timing (CUDA events around bursts of 10 back-to-back calls, median of
     5 bursts) at the 480px predict shapes (batch 3) and, for the
     backward, the train bench's microbatch shapes: kernel,
     plain version, one PyTorch library call, and the card's bound; then
     the cli/bench line (predict and train);
  7. the per-kernel summary line, the card line, and the final status line.
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
from dino_tpu_torch.ops.attention import (attention_bwd_plain,
                                          attention_plain, flash_attention,
                                          flash_attention_bwd)
from dino_tpu_torch.ops.fused_mlp import (fused_ln_mlp_residual,
                                          fused_ln_mlp_residual_plain)
from dino_tpu_torch.train.loop import (init_opt_state, make_optimizer,
                                       make_train_step)

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
# flash backward vs its plain version.  f32: dino_tpu's own test of its
# Pallas backward (tests/test_attention.py:66).  bf16: both round P and dS
# to bf16 from f32 scores summed in another order, so an element at a
# rounding edge may land one bf16 step (2^-8) apart, and such steps add up
# over the N terms of each sum: max |err| per tensor against its max |ref|.
BWD_F32_TOL = (5e-5, 1e-4)
BWD_BF16_REL = 2e-2
# card fp32 train step vs the CPU's on the same weights and batch: the loss,
# and each gradient leaf against its largest magnitude (true float32 on both
# sides, sums in another order; TF32 would show at ~1e-3)
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_REL = 1e-4


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase record also gets ``t``, the seconds since the
    script started."""
    if "phase" in obj:
        obj = dict(obj, t=time.perf_counter() - _T0)
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def median_ms(fn, rounds=5, burst=10, warmup=3):
    """Device time of one call of ``fn``: CUDA events around a burst of
    ``burst`` back-to-back calls, so the host enqueues ahead of the device
    and its per-call latency stays out; the median over ``rounds``
    bursts."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
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
    return [torch.randn(bh // 6, 6, n, 64, generator=g,
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


def bwd_inputs(bh, n, dtype, seed):
    """q, k, v, dO (B, nh, N, 64) and the forward kernel's out and lse."""
    q, k, v = flash_inputs(bh, n, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    out, lse = flash_attention(q, k, v, SCALE, return_lse=True)
    return q, k, v, do, out, lse


def bwd_err(got, ref, dtype):
    """(max |err| of dq, dk, dv, within tolerance)."""
    errs, ok = [], True
    for a, b in zip(got, ref):
        err = (a - b).abs()
        errs.append(err.max().item())
        if dtype == torch.float32:
            atol, rtol = BWD_F32_TOL
            ok &= bool((err <= atol + rtol * b.abs()).all())
        else:
            ok &= errs[-1] <= BWD_BF16_REL * b.abs().max().item()
    return errs, ok


def phase_bwd_kernel():
    """The flash backward vs its plain version; returns the max error at
    the train bench's microbatch shapes (bf16, B*nh = 12, N = 3,601)."""
    worst = None
    for dtype in (torch.bfloat16, torch.float32):
        for n in (37, 901, 3601, 14401):
            for bh in (6, 12, 18):
                q, k, v, do, out, lse = bwd_inputs(bh, n, dtype, seed=n + bh)
                got = flash_attention_bwd(q, k, v, out, lse, do, SCALE)
                torch.cuda.synchronize()
                ref = attention_bwd_plain(q, k, v, out, lse, do, SCALE)
                errs, ok = bwd_err(got, ref, dtype)
                rec = {"phase": "kernel_check", "kernel": "flash_attn_bwd",
                       "dtype": str(dtype).split(".")[1], "bh": bh, "n": n,
                       "max_abs_err": max(errs), "dq_err": errs[0],
                       "dk_err": errs[1], "dv_err": errs[2],
                       "max_abs_ref": max(r.abs().max().item() for r in ref),
                       "tol": (list(BWD_F32_TOL) if dtype == torch.float32
                               else f"{BWD_BF16_REL} x max|ref| per tensor")}
                emit(rec)
                check(ok, f"flash backward {rec}")
                if dtype == torch.bfloat16 and n == 3601 and bh == 12:
                    worst = rec["max_abs_err"]
                del q, k, v, do, out, lse, got, ref
    return worst


def counts():
    return (flash_attention.launches, fused_ln_mlp_residual.launches,
            flash_attention_bwd.launches)


def zero_counts():
    flash_attention.launches = 0
    fused_ln_mlp_residual.launches = 0
    flash_attention_bwd.launches = 0


def phase_main_path(model, frame, frames3):
    """predict / predict_batch through the public API; returns the launch
    counts of the whole run and per bf16 batch-3 predict."""
    zero_counts()
    per_call = {}
    for prec in ("bf16", "fp32"):
        for res in (240, 480, 960):
            model.set_resolution(res)
            before = counts()
            t0 = time.perf_counter()
            out = model.predict(frame, precision=prec)
            dt = time.perf_counter() - t0
            d_flash, d_mlp, _ = (a - b for a, b in zip(counts(), before))
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
          "total_fused_mlp_launches": total[1],
          "total_flash_bwd_launches": total[2]})
    check(total[2] == 0, "predict launched the backward kernel")
    check(total[0] > 0 and total[1] > 0, "a kernel was never launched")
    return {"flash_attn_fwd": total[0], "fused_ln_mlp": total[1]}, per_call


def trainables(vit, head, frozen):
    return list(head.parameters()) + ([] if frozen else list(vit.parameters()))


def train_run(model, frozen, precision, res, batch, accum, steps, want,
              seed):
    """``steps`` train steps through make_train_step; checks the launches
    of every step against ``want`` (flash fwd, fused MLP, flash bwd), a
    finite loss, that the trained parameters moved and that a frozen
    backbone kept its bits.  Returns the last step's loss."""
    vit, head = model.model.dino, model.model.clf
    cdt = torch.bfloat16 if precision == "bf16" else None
    opt = make_optimizer("adam", 1e-5)
    opt_state = init_opt_state(opt, vit, head, frozen)
    step = make_train_step(model.cfg, "mlp", 7, opt, frozen,
                           compute_dtype=cdt, accum_steps=accum)
    rs = np.random.RandomState(seed)
    out = res // 8
    labels = torch.from_numpy(rs.randint(0, 7, (batch, out * out)).astype(
        np.int32)).cuda()
    imgs = torch.from_numpy(rs.randint(0, 255, (batch, res, res, 3)).astype(
        np.uint8)).cuda()
    before_p = [p.detach().clone() for p in trainables(vit, head, frozen)]
    before_bb = [p.detach().clone() for p in vit.parameters()]
    for i in range(steps):
        before = counts()
        t0 = time.perf_counter()
        loss, cm = step(vit, head, opt_state, imgs, labels)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = [a - b for a, b in zip(counts(), before)]
        rec = {"phase": "train_path", "frozen": frozen,
               "precision": precision, "res": res, "batch": batch,
               "accum_steps": accum, "step": i, "loss": loss.item(),
               "cm_total": int(cm.sum()), "flash_launches": got[0],
               "fused_mlp_launches": got[1], "flash_bwd_launches": got[2],
               "host_s": dt}
        emit(rec)
        check(got == list(want), f"train launches {got}, want {want}")
        check(bool(torch.isfinite(loss)), f"non-finite loss {rec}")
        check(int(cm.sum()) == batch * out * out, "confusion matrix total")
    moved = [not torch.equal(a, b) for a, b in
             zip(before_p, trainables(vit, head, frozen))]
    check(all(moved), f"{moved.count(False)} trained tensors did not move")
    if frozen:
        check(all(torch.equal(a, b) for a, b in
                  zip(before_bb, vit.parameters())),
              "a frozen backbone parameter changed")
    return loss


def phase_train_path():
    """make_train_step on the card; returns the total backward launches of
    the phase and the launches per unfrozen bf16 step."""
    zero_counts()
    model = DINOSeg(head="mlp", n_blocks=3, n_classes=7, precision="bf16",
                    random_init=True, seed=1, freeze_backbone=False)
    # unfrozen bf16 at the train bench's shapes: 8 microbatches x 3 blocks
    train_run(model, False, "bf16", 480, 16, 8, 3, (24, 0, 24), seed=2)
    model.freeze_bb()
    train_run(model, True, "bf16", 480, 16, 8, 1, (24, 24, 0), seed=3)
    model.unfreeze_bb()
    cpu = DINOSeg(head="mlp", n_blocks=3, n_classes=7, precision="fp32",
                  random_init=True, device="cpu", freeze_backbone=False)
    cpu.load_state_dict({k: v.cpu() for k, v in
                         model.model.state_dict().items()})
    loss = train_run(model, False, "fp32", 240, 2, 1, 1, (3, 0, 3), seed=4)
    total = counts()
    emit({"phase": "train_path", "total_flash_launches": total[0],
          "total_fused_mlp_launches": total[1],
          "total_flash_bwd_launches": total[2]})
    check(total[2] > 0, "the backward kernel was never launched")
    phase_train_cpu_reference(model, cpu, loss.item(), seed=4)
    return total[2], 24


def phase_train_cpu_reference(card, cpu, card_loss, seed):
    """The card's fp32 240px step (just taken, gradients still in .grad)
    against the same step on the CPU from the same weights and batch."""
    vit, head = cpu.model.dino, cpu.model.clf
    opt = make_optimizer("adam", 1e-5)
    step = make_train_step(cpu.cfg, "mlp", 7, opt, False)
    rs = np.random.RandomState(seed)
    labels = torch.from_numpy(rs.randint(0, 7, (2, 900)).astype(np.int32))
    imgs = torch.from_numpy(rs.randint(0, 255, (2, 240, 240, 3)).astype(
        np.uint8))
    loss, _ = step(vit, head, init_opt_state(opt, vit, head, False), imgs,
                   labels)
    worst, worst_name, ok, diffs = 0.0, None, True, {}
    card_params = dict(card.model.named_parameters())
    for name, p in cpu.model.named_parameters():
        g_card = card_params[name].grad
        check(g_card is not None, f"no gradient reached {name} on the card")
        diffs[name] = (g_card.cpu() - p.grad).abs().max().item()
        rel = diffs[name] / max(p.grad.abs().max().item(), 1e-30)
        ok &= rel <= STEP_GRAD_REL
        if rel >= worst:
            worst, worst_name = rel, name
    rec = {"phase": "train_cpu_reference", "res": 240, "precision": "fp32",
           "loss_card": card_loss, "loss_cpu": loss.item(),
           "grad_max_abs_diff": diffs,
           "grad_worst_rel_diff": worst, "grad_worst_leaf": worst_name,
           "tol": {"loss_rtol": STEP_LOSS_RTOL,
                   "grad_rel_per_leaf": STEP_GRAD_REL}}
    emit(rec)
    check(abs(card_loss - loss.item()) <= STEP_LOSS_RTOL * abs(loss.item()),
          f"card fp32 step loss disagrees with the CPU {rec}")
    check(ok, f"card fp32 gradients disagree with the CPU {rec}")


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


def phase_timing(block, per_call, bwd_per_step):
    """Per kernel at the 480px batch-3 predict shapes; the backward at the
    train bench's microbatch shapes (batch 2 x 6 heads, N = 3,601)."""
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
    q, k, v, do, out, lse = bwd_inputs(12, 3601, torch.bfloat16, seed=8)
    b, nh, n, hd = q.shape
    flops = 10 * n * n * hd * b * nh
    # q, k, v, dO in; lse, D in (f32); dq, dk, dv out (f32)
    nbytes = (4 * q.element_size() + 2 * 4 / hd + 3 * 4) * b * nh * n * hd
    bnd, by = bound_ms(flops, nbytes, torch.bfloat16)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qs, ks, vs, scale=SCALE)
    rows["flash_attn_bwd"] = {
        "ms": median_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do,
                                                    SCALE)),
        "plain_ms": median_ms(lambda: attention_bwd_plain(q, k, v, out, lse,
                                                          do, SCALE)),
        "library_ms": median_ms(lambda: sdpa.backward(do, retain_graph=True)),
        "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes,
        "launches_per_train_step": bwd_per_step}
    for name, row in rows.items():
        shape = ("480px train microbatch (2 x 6 heads)"
                 if name == "flash_attn_bwd" else "480px batch 3")
        emit(dict({"phase": "timing", "kernel": name, "shape": shape,
                   "kernel_ms": row["ms"]}, **row))
    return rows


KERNELS = {
    "flash_attn_fwd": dict(
        source="dino_tpu_torch/csrc/flash_attn_fwd.cu",
        replaces="dino_tpu/ops/attention.py:90", tpu_kernel="_flash_kernel"),
    "fused_ln_mlp": dict(
        source="dino_tpu_torch/csrc/fused_ln_mlp.cu",
        replaces="dino_tpu/ops/fused_mlp.py:38", tpu_kernel="_kernel"),
    "flash_attn_bwd": dict(
        source="dino_tpu_torch/csrc/flash_attn_bwd.cu",
        replaces="dino_tpu/ops/attention.py:580",
        tpu_kernel="_flash_bwd_kernel"),
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
    errs["flash_attn_bwd"] = phase_bwd_kernel()

    rs = np.random.RandomState(0)
    frame = rs.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    frames3 = rs.randint(0, 256, (3, 480, 640, 3)).astype(np.uint8)
    launches, per_call = phase_main_path(model, frame, frames3)
    phase_cpu_reference(model, frame)
    launches["flash_attn_bwd"], bwd_per_step = phase_train_path()
    rows = phase_timing(block, per_call, bwd_per_step)
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
