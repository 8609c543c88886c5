#!/usr/bin/env python3
"""On-card smoke test of dino_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout; exits non-zero on any
failure (and before printing any result when there is no card).  Phases,
each printing JSON lines:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds the kernels of dino_tpu_torch/csrc at first use;
     ptxas's registers and spills per kernel, failing on a spill (or
     ptxas's C7512, wgmma serialized for want of registers) in the bf16
     forward, the fused MLP or either backward kernel;
  3. kernels vs their plain PyTorch versions on the card, at the main
     path's shapes, each against its stated tolerance; every kernel run
     twice and held to the same bits; the bf16 forward at query counts
     around its 128-row blocks and key bounds around its key tiles, the
     fused MLP at row counts around its 64-row blocks (up to batch 16) and
     at hidden widths 64 and 1,536; the f32 backward at query counts around
     its tiles and blocks, static and with key bounds around them;
  4. main path: DINOSeg.predict / predict_batch on random ViT-S/8 weights
     (3 blocks, MLP head, 7 classes) at 240/480/960px in bf16 and fp32,
     with every kernel's launch count read before and after;
  5. train path: make_train_step on the same model config, unfrozen bf16
     at 480px (batch 16, 8 microbatches, 3 steps), frozen bf16 (1 step) and
     unfrozen fp32 at 240px (batch 2, 1 step), with the launch counts read
     around every step; the fp32 step is repeated on the CPU from the same
     weights and batch and its loss and gradients compared;
  6. sequence parallelism (ring attention): the dynamic-bound kernels vs
     their plain versions at the per-hop shapes of a 960px ring over 1, 2
     and 4 ranks (sp_kernels); SP predict_batch at 960px in a world of one
     over NCCL (sp_path); two rank processes sharing the card over gloo,
     started right after the build and joined before the timing, each
     running SP predict and one SP train step (fp32 and bf16) against the
     single-device predict and make_train_step (sp_path, rank records);
  7. the streaming forward past dino_tpu's 8 resident K/V slices: an fp32
     predict at 1624px (N = 41,210, where dino_tpu runs its chunked kernel)
     and the kernel vs its plain version at that N;
  8. attention maps (attention_maps) on the main path's model: at 240px
     get_last_selfattention (full and CLS-row only, with and without 4
     masks), forward_mask and get_intermediate_layers (fp32 and bf16)
     against the port's own CPU run, with their launches; at 480px batch 3
     the full matrix's row sums and its row 0 against the CLS-row call; at
     960px the CLS-row call and 8 masks under 1 GiB of peak memory (an
     N x N matrix: 4.98 GB); the visualization CLIs' arrays; predict_stream
     (10 frames, batch 4) equal to predict_batch on the padded batches, bit
     for bit; its host frame rate over 256 frames against a loop of
     predict_batch, after an untimed run of each, two readings in turns;
  9. fit: DINOSeg.fit on an in-memory split (the colour bands of
     tests/test_train_smoke.py at 480x640, 7 classes; 12 train, 4 val, 4
     test frames), handed in through a subclass's _make_dataset: (a) the
     unfrozen bf16 fit at the train bench's config (480px, batch 16, 8
     microbatches, Adam 1e-5, augmented, 64 samples an epoch, 2 epochs),
     with the loader alone over one epoch's samples, each epoch's host
     frames/s, loader wait, mean step time and core share, and the bare
     step's rate of phase 5; (b) the frozen bf16 fit over the feature
     cache (no flash launch in its epochs); (c) the fp32 fit at 240px
     (batch 2) against the same fit on the CPU, a resumed fit against the
     uninterrupted one (the same bits) and evaluate against fit's test
     metrics; (d) the device augmentation (ops/device_augment.py) of one
     staged 480px batch of 16 that reaches every op, on the card against
     the port's CPU run, the same bits twice, with its device ms per batch
     (CUDA events over bursts), host ms per call and device kernels per
     batch (torch.profiler); (e) (a)'s fit with augment_backend='device',
     with (a)'s host-pipeline numbers and the loader alone on the device
     route, beside (a)'s and the bare step's; exact launch counts for
     each;
  10. serve: (a) export_predict at the bench config (bf16, batch 3,
     480x640 frames at 480px) and an fp32 artifact at 240px, batch 1,
     loaded (the program captured as a CUDA graph) and held to eager
     predict_batch bit for bit, twice, with each replay's kernels counted
     by torch.profiler (the wrappers count the warm-up and the capture);
     (b) the server (cli/serve.make_server) over the bench checkpoint with
     --max_batch 3: a PNG body, a JPEG body against its own decode, the
     four formats and the Accept header, /healthz, /stats, and rounds of
     1, 2 and 3 frames against predict_batch of the same bucket, bit for
     bit, with the programs' peak memory; (c) load: 12 client threads
     post 512 requests of 300 distinct JPEGs (npy8 answers), --max_batch
     3 and 1, two readings each in turns: served frames/s, /stats p50 and
     p95, the rounds' histogram, the process's host core share; (d) in
     process, eager predict_batch against the program at the bench config
     in turns: host ms per batch, device busy ms and idle share;
  11. int8, MoE, cnn (item8): (a) int8 at the bench config: every
     quantized layer's codes and scales on the card the same bits as the
     CPU's, predict_batch(precision='int8') against the port's CPU int8
     run (labels equal except at top-2 gaps below INT8_MARGIN), agreement
     with bf16 (recorded), the int8 artifact's CUDA-graph replay equal to
     eager int8 twice, 3 flash launches and no fused-MLP launch per batch;
     host ms, device busy ms and idle share of int8 and bf16 predict_batch
     in turns, eager and through the program, and torch._int_mm against
     the bf16 mm at fc1's shape (10,803 x 384 x 1,536); (b) the MoE head (4
     experts) on the bench ViT: dense and sparse (capacity factor 4) bf16
     predict at 480px with the same labels, the unfrozen bf16 train step at
     the train bench config (2 steps, exact launches with the stats pass's
     forwards), the fp32 step at 240px against the CPU, one SP fp32 step in
     a world of one over NCCL against the single-device step; (c) cnn1 and
     cnn2 on seeded random weights: fp32 and bf16 predict at 480px against
     the CPU, one train-mode fp32 step at 240px against the CPU (loss,
     gradients, running stats), the peak memory of batch 3; no kernel of
     ours may launch there (dino_tpu's ResNet runs no Pallas kernel);
  12. pretrain (DINO self-supervised pretraining): (a) the flash forward
     and backward (kernels 1 and 3), f32 and bf16, at the pretrain step's
     shapes (B*nh, N) = (768, 145) and (192, 785) against their plain
     versions, the same bits twice, timed as CUDA-graph replays beside
     SDPA, with the bound; (b) one f32 step at depth 2, batch 2 (ViT-S/8,
     DinoConfig's widths) on the card against the port's CPU step from the
     same weights and crops: loss, clipped gradients, post-step student,
     teacher and centre; (c) the full-width step (ViT-S/8, 12 blocks,
     out_dim 65,536, 2 x 224 + 8 x 96 px views, batch 16) in f32 as the
     CLI runs it (one warm-up, 3 timed steps and one profiled: host and
     busy ms, idle share, images/s, peak memory) and in bf16, each step's
     launches exact; (d) the pretrain_dino CLI on the card at depth 1 on
     JPEGs written here, and DINOSeg(pretrained_path=<its npz>).predict;
  13. training over ranks (dp): the kernels at the ranks' shapes that
     phases 3, 6 and 12 do not cover against their plain versions, then
     two rank processes sharing the card over gloo (started and joined
     here, after phase 12): (a) the bench config (bf16, 480px, global
     batch 16, 8 a rank in 4 microbatches of 2) under plain data
     parallelism, ZeRO-1 and FSDP, one warm-up and 3 timed steps each,
     the ranks' parameters the same bits after every step, host ms, the
     collectives' ms, peak memory and state bytes per rank, ZeRO and FSDP
     against plain DP, FSDP's peak below DP's and at most two units'
     parameters and one unit's gradient gathered at once; (b) fp32 at
     240px, global batch 4: the DP and FSDP steps' gradients against the
     world-of-one step from the same weights and batch (ReLU choices
     replayed), and one fit(parallelism='sp')
     epoch's step against the world-of-one SP step; (c) a 2-rank fit of
     one epoch on phase 9's bands (bf16, augmented, beside phase 9 (a)'s
     frames/s) and the ranks' evaluate, whose confusion matrix equals the
     world of one's on rank 0's checkpoint; (d) the full-width pretrain step (f32, global
     batch 16) without and with FSDP (images/s, peak memory before the
     first step and over the steps, state bytes, the collectives; FSDP
     built on the host, gathering one unit at a time, its peak below DP's
     by at least a quarter of DP's state bytes) and the pretrain CLI over
     the ranks with --fsdp;
     exact launch counts throughout, summed into the kernels line;
  14. tensor parallelism (tp): the kernels at the TP paths' shapes that
     earlier phases do not cover (a rank's head group of the 480px
     predict, the DP x TP microbatch, the 2 x 2 SP x TP hop) against their
     plain versions, then rank processes sharing the card over gloo: a
     world of 2 runs (a) predict_batch(parallelism='tp') at the bench
     config, batch 3 and 1, bf16 and fp32, against the world of one (fp32
     labels equal except top-2 gaps under MARGIN, bf16 under 1e-2; every
     rank the same bits; 3 forward launches a call, no fused MLP) and (c)
     the bf16 unfrozen step at the train bench's shapes with the blocks
     split over the ranks (host ms, the model group's all-reduce ms, the
     whole parameters the same bits on every rank); a world of 4 on the 2 x
     2 grid (parallel/mesh.py:make_grid) runs (b) the fp32 240px DP x TP
     step without and with ZeRO-1 and the SP x TP step against the world
     of one (loss, every gradient leaf within STEP_GRAD_REL of its max,
     ZeRO-1 the plain bits), then the bf16 SP x TP step; exact launch
     counts, summed into the kernels line;
  15. pipeline parallelism (pp) on the whole 12-block ViT-S/8 (MLP head, 7
     classes): the kernels at the PP paths' shapes that earlier phases do
     not cover, the plain 12-block bf16 step at the bench shape (the world
     of one), then rank processes sharing the card over gloo: a world of 2
     runs (a) fp32 at 240px, batch 2 in 2 microbatches, the 1F1B,
     interleaved 1F1B (V = 2) and GPipe steps, every gradient leaf within
     STEP_GRAD_REL of its max of the world-of-one step (ReLU choices
     replayed), (b) bf16 at the bench shape (480px, batch 16 in 8
     microbatches) the pipelined forward against vit_forward and 3 timed
     1F1B steps (step ms, frames/s, hop ms, each rank's bytes of blocks and
     moments against the whole model's, the peak; every step's loss within
     2e-2 of the world of one's, and the first step's gradients within
     PP_BF16_GRAD_REL of the world of one's bf16 step on the same
     microbatches), (c) one fp32 fit(parallelism='pp') epoch
     on phase 9's bands, its train metrics the plain fit's; a world of 4
     runs (d) the DP x PP x TP step (data 1 x stage 2 x model 2) against
     the world of one; exact launch counts, summed into the kernels line;
  16. one process over several cards (cards), on the main path's model:
     (a) the batch split of predict_batch (api.py:_launch_split) with two
     chunks on card 0, at batch 4, fp32 and bf16, against the one-card
     program at batch 2 on each chunk and eager predict_batch (the same
     bits), with its host ms beside one card's at batch 2 and 8; the
     in-process SP ring (parallel/ring_attention.py:ring_attention_local)
     with two shards on card 0 at 960px against the one-card forward (fp32
     labels equal except top-2 gaps under MARGIN, log-probs within
     SP_FWD_TOL; 12 launches of kernel 5, no fused MLP), with its host ms;
     an artifact for one card more than the machine has, refused at load;
     utils/profiling.py:device_trace around one predict, whose trace must
     name the bf16 flash forward; the launches summed into the kernels
     line;
  17. timing (CUDA events around bursts of back-to-back calls, median of
     the bursts; the bf16 kernels and the f32 backward also replayed from a
     CUDA graph, which takes the host out) at the 480px predict shapes
     (batch 3; the fused MLP also at one frame), the train bench's
     microbatch shapes for the backward (and the fp32 step's at 240px and
     at N = 3,601 for the f32 backward), the 2-rank 960px per-hop shape for
     the dynamic-bound kernels and the 1624px shape (and the 960px fp32
     predict's N) for the f32 forward: kernel, plain version, one PyTorch
     library call (for the forwards also the device kernels it runs), the
     fused MLP's eager bf16 composition, and the card's bound (the f32
     forward's and backward's on their route: three TF32 passes); the fp32
     predict latency at 480 and 960px; then the cli/bench line
     (predict and train);
  18. the per-kernel summary line, the card line, and the final status
      line.

``python3 chip_smoke.py --sp-world W`` (W cards) runs only phase 6's rank
checks with one rank per card over NCCL, ``--dp-world W`` phase 13's DP,
ZeRO and FSDP checks ((a) and (b)'s steps and (d), FSDP's gradients
reduce-scattered by NCCL) beside (a)'s DP step in a world of one on card 0,
``--tp-world W`` phase 14's
(a) over NCCL in worlds of 2 and W ranks, with the TP predict latency at
batch 1 and 3 beside the world of one's on card 0, one all-reduce's ms,
each rank's peak memory and weight bytes, and with W = 4 (b) on 2 x 2
cards.  ``--pp-world W`` runs phase 15's (b) over NCCL with one rank a card
(S = W, the 1F1B and interleaved 1F1B steps), beside the world of one's
12-block step on card 0 in the same call, with the hop ms, each rank's
bytes and peak.  ``--cards N`` (N >= 2 cards in one process) runs phase
16 (b) over cards 0..N-1 and over cards 0 and 1: the DP artifact at batch
2N and the split predict_batch at twice the card count against the
one-card program's bits, the SP artifact at 960px against one card as in
(a), the warm host ms of each beside one card's (graph replays for DP,
eager for SP), and a ring hop's peer copy ms.  ``--sp-rank R --sp-world W --sp-store PATH --sp-backend
B`` (and ``--dp-rank ...``, ``--tp-rank ...``, ``--pp-rank ...``) is one
rank process (started by the script itself).
"""
import argparse
import contextlib
import copy
import functools
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from dino_tpu_torch import DINOSeg, export_predict, load_exported_predict
from dino_tpu_torch.api import collect_labels, label_maps, seg_log_probs_sp
from dino_tpu_torch.cli import bench
from dino_tpu_torch.cli.serve import make_server
from dino_tpu_torch.cli.visualize import overlay
from dino_tpu_torch.cli.visualize_attention import attention_maps
from dino_tpu_torch.data import native_loader
from dino_tpu_torch.data.augment import (draw_params, prepare_device_batch,
                                         resize_pair)
from dino_tpu_torch.data.dataset import (DuckieSegDataset, batched_loader,
                                         epoch_indices, loader_route)
from dino_tpu_torch.models.vit import Mlp, ViTConfig, get_intermediate_layers
from dino_tpu_torch.ops import _build
from dino_tpu_torch.ops import attention as tatt
from dino_tpu_torch.ops.attention import (attention_bwd_dyn_plain,
                                          attention_bwd_plain,
                                          attention_dyn_plain, attention_plain,
                                          flash_attention, flash_attention_bwd,
                                          flash_attention_bwd_dyn,
                                          flash_attention_with_lse_dyn)
from dino_tpu_torch.ops.device_augment import MAX_BLUR, device_augment_batch
from dino_tpu_torch.ops.fused_mlp import (fused_ln_mlp_residual,
                                          fused_ln_mlp_residual_plain)
from dino_tpu_torch.ops.preprocess import preprocess
from dino_tpu_torch.ops.resize import resize_nearest
from dino_tpu_torch.parallel import dist as pdist
from dino_tpu_torch.parallel.mesh import (FSDPOptimizer, ShardedOptimizer,
                                          materialize)
from dino_tpu_torch.parallel.ring_attention import make_sp_train_step
from dino_tpu_torch.precision import matmul_ctx
from dino_tpu_torch.serving import predict_program
from dino_tpu_torch.models.vit import vit_small
from dino_tpu_torch.train.dino_pretrain import (DinoConfig, init_dino_params,
                                                make_dino_optimizer,
                                                make_dino_train_step,
                                                shard_dino_state)
from dino_tpu_torch.train.loop import (init_opt_state, make_optimizer,
                                       make_train_step)
from dino_tpu_torch.utils.frames import process_attentions
from dino_tpu_torch.utils.profiling import device_trace

# H100 SXM published peaks (dense): bf16 tensor cores, f32 CUDA cores, TF32
# tensor cores (the f32 forward's route: three TF32 products per product),
# HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}
TF32_PASSES = 3
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
# the dynamic-bound backward: the flash backward's rates (f32 rtol 1e-4, bf16
# 2e-2: BWD_F32_TOL, BWD_BF16_REL), each
# tensor's max |err| against the hop's largest |ref| among dq, dk, dv.  With
# one valid key the softmax is constant: dq and dk vanish in exact arithmetic
# and both versions return float32 noise, and dv is the plain sum of N rows
# of dO, which the kernel accumulates row by row (measured at N = 14,401:
# |err| 1.1e-3 against |dv| up to 386, failing an elementwise rule)
BWD_DYN_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# SP bf16 train step vs the single-device bf16 step: the SP block rounds
# at the JAX package's SP points (dense qkv, GELU of the rounded fc1)
SP_BF16_LOSS_RTOL = 1e-2
# SP fp32 gradients: STEP_GRAD_REL per leaf, with the head's ReLU choices
# held equal.  A head unit whose pre-activation sits at 0 within float32
# rounding takes either side depending on the order of sums, and at 960px
# batch 2 one such choice moves pos_embed (whose entries sum
# bicubic-weighted token gradients that cancel) by about 2e-2 of its max.
# Any other valid rounding may flip it (regrouping the batch in two
# microbatches did, with another f32 forward), so no other step is a
# yardstick for it: the SP step replays the single-device step's ReLU
# masks (head_relu) and reports how many units it would have flipped.
SP_RES = 960
SP_N_REAL = (SP_RES // 8) ** 2 + 1  # 14,401 tokens
SP_WORLD = 2          # rank processes sharing the card in phase 6
SP_RANK_TIMEOUT = 600  # seconds for the rank processes, from their start
CHUNKED_RES = 1624    # 203 x 203 + 1 = 41,210 tokens: dino_tpu's chunked
                      # kernel in f32 (past 8 resident K/V slices)
FWD_BQ = 128          # query rows per block of the bf16 forward (csrc FB_BQ)
# query counts of the f32 backward's edge checks: both sides of its 64-row
# warpgroups and 128-row blocks (csrc B_ROWS), around its 32-row tiles
BWD_EDGE_N = (63, 64, 65, 127, 128, 129)
# row counts and hidden widths of the fused-MLP edge checks: both sides of
# the 64-row blocks, one frame, 480px batch 3 and batch 16
MLP_EDGE_M = (1, 63, 64, 65, 129, 3601, 10803, 57616)
MLP_EDGE_H = (64, 1536)
# the kernels whose ptxas report must show no spill and no C7512 (wgmma
# serialized for want of registers)
NO_SPILL = ("flash_fwd_bf16", "fused_ln_mlp_kernel", "flash_bwd_bf16",
            "flash_bwd_f32")
# attention maps (phase 8): card f32 outputs vs the CPU's, max |err| against
# each output's largest |ref|; bf16 intermediate layers by FLASH_TOL's bf16
# rates, also against the tensor's largest |ref| (atol + rtol x max|ref|):
# each token is LayerNorm'd, so an element near 0 carries the rounding of
# the token's large elements, scaled by 1/std (measured on the card: 0.039
# at max|ref| 4.75, 5 bf16 ulps of a unit-size element, where the card runs
# the fused MLP and the CPU the composition); the full matrix's rows sum to
# 1, and the CLS row of cls_only equals the full matrix's row 0, within
# ATTN_ROWSUM_ATOL and ATTN_CLS_ROW_ATOL
ATTN_F32_REL = 1e-5
ATTN_ROWSUM_ATOL = 1e-5
ATTN_CLS_ROW_ATOL = 1e-6
ATTN_MASKS = 4
ATTN_960_MASKS = 8
ATTN_PEAK_LIMIT = 1 << 30   # bytes the 960px CLS-row and mask calls may add
STREAM_FRAMES, STREAM_BATCH = 10, 4
# predict_stream's frame rate: 64 batches of 4, two readings in turns with
# the predict_batch loop
STREAM_TIMED_FRAMES, STREAM_READINGS = 256, 2


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


def graph_ms(fn, rounds=5, burst=10, warmup=3):
    """Device time of one call of ``fn`` with the host out of the way: a
    CUDA graph of ``burst`` back-to-back calls, CUDA events around its
    replays, the median over ``rounds``.  Eager bursts (median_ms) measure
    the host's enqueue rate instead once a kernel takes less time than its
    wrapper's Python and launch work."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(burst):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return float(np.median(times))


def kernel_times(fn, **burst):
    """{"ms": graph_ms, "ms_eager": median_ms} of one kernel call."""
    return {"ms": graph_ms(fn, **burst), "ms_eager": median_ms(fn, **burst)}


def bound_ms(flops, nbytes, dtype):
    """Least time the card could take: max(operations / peak rate, bytes /
    memory rate), in ms, and which of the two bounds it.  ``dtype`` "tf32"
    counts the f32 forward's route: TF32_PASSES TF32 products each."""
    t_ops = flops / PEAK_FLOPS[dtype] * (TF32_PASSES if dtype == "tf32"
                                         else 1)
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
                again, lse_again = flash_attention(q, k, v, SCALE,
                                                   return_lse=True)
                out_only = flash_attention(q, k, v, SCALE)
                torch.cuda.synchronize()
                ref, ref_lse = attention_plain(q, k, v, SCALE)
                err = (out.float() - ref.float()).abs()
                tol = atol + rtol * ref.float().abs()
                rec = {"phase": "kernel_check", "kernel": "flash_attn_fwd",
                       "dtype": str(dtype).split(".")[1], "bh": bh, "n": n,
                       "max_abs_err": err.max().item(),
                       "lse_max_abs_err": (lse - ref_lse).abs().max().item(),
                       "same_bits_twice": bool(torch.equal(out, again)
                                               and torch.equal(lse, lse_again)),
                       "tol": [atol, rtol, LSE_ATOL]}
                emit(rec)
                check(bool((err <= tol).all()), f"flash out {rec}")
                check(rec["lse_max_abs_err"] <= LSE_ATOL, f"flash lse {rec}")
                check(torch.equal(out, out_only), "flash out with/without lse")
                check(rec["same_bits_twice"], f"flash bits differ {rec}")
                if dtype == torch.bfloat16 and n == 3601 and bh == 18:
                    errs["flash_attn_fwd"] = rec["max_abs_err"]
                del q, k, v, out, lse, again, lse_again, out_only, ref
                del ref_lse, err, tol
    g = torch.Generator(device="cuda").manual_seed(1)
    for m in (10803, 1000):
        max_err = check_mlp(block.norm2, block.mlp, m, g)
        if m == 10803:
            errs["fused_ln_mlp"] = max_err
    return errs


def check_mlp(norm, mlp, m, g):
    """The fused MLP on m random rows, twice (the same bits), against its
    plain version under mlp_err's tolerance; returns the max error."""
    x = (torch.randn(m, 384, generator=g, device="cuda") * 0.5
         ).to(torch.bfloat16)
    with torch.no_grad():
        out = fused_ln_mlp_residual(norm, mlp, x, EPS)
        again = fused_ln_mlp_residual(norm, mlp, x, EPS)
        torch.cuda.synchronize()
        ref = fused_ln_mlp_residual_plain(norm, mlp, x, EPS)
    max_err, ulps, ok = mlp_err(out, ref, x)
    rec = {"phase": "kernel_check", "kernel": "fused_ln_mlp", "m": m,
           "hidden": mlp.fc1.weight.shape[0], "max_abs_err": max_err,
           "max_err_bf16_ulps": ulps,
           "same_bits_twice": bool(torch.equal(out, again)),
           "tol": "2 bf16 ulps of max(|x|,|ref|,|h|) + 1 ulp of rms(h)"}
    emit(rec)
    check(ok, f"fused MLP {rec}")
    check(rec["same_bits_twice"], f"fused MLP bits differ {rec}")
    return max_err


def phase_edges(block):
    """The bf16 forward at query counts around its block rows (FWD_BQ),
    B*nh = 1, static and dynamic-bound with bounds around the key tiles;
    the fused MLP at MLP_EDGE_M rows with hidden widths MLP_EDGE_H.  Each
    kernel runs twice and is held to the same bits."""
    atol, rtol = FLASH_TOL[torch.bfloat16]
    for n in (FWD_BQ - 1, FWD_BQ, FWD_BQ + 1):
        g = torch.Generator(device="cuda").manual_seed(n)
        q, k, v = (torch.randn(1, 1, n, 64, generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(3))
        calls = [("static", n, lambda: flash_attention(q, k, v, SCALE,
                                                       return_lse=True))]
        for valid in sorted({0, 1, 63, 64, 65, 127, 128, 129, n}):
            if valid <= n:
                calls.append(("dyn", valid, functools.partial(
                    flash_attention_with_lse_dyn, q, k, v, SCALE, valid)))
        for entry, valid, fn in calls:
            (out, lse), (again, lse2) = fn(), fn()
            torch.cuda.synchronize()
            ref, ref_lse = attention_dyn_plain(q, k, v, SCALE, valid)
            err = (out.float() - ref.float()).abs()
            rec = {"phase": "kernel_check", "kernel": "flash_attn_fwd_edges",
                   "entry": entry, "bh": 1, "n": n, "valid": valid,
                   "max_abs_err": err.max().item(),
                   "lse_max_abs_err": (lse - ref_lse).abs().max().item(),
                   "same_bits_twice": bool(torch.equal(out, again)
                                           and torch.equal(lse, lse2)),
                   "tol": [atol, rtol, LSE_ATOL]}
            emit(rec)
            check(bool((err <= atol + rtol * ref.float().abs()).all()),
                  f"flash edge {rec}")
            check(rec["lse_max_abs_err"] <= LSE_ATOL if valid
                  else lse.max().item() <= -1e29, f"flash edge lse {rec}")
            check(rec["same_bits_twice"], f"flash edge bits differ {rec}")
    g = torch.Generator(device="cuda").manual_seed(4)
    for hidden in MLP_EDGE_H:
        if hidden == block.mlp.fc1.weight.shape[0]:
            norm, mlp = block.norm2, block.mlp
        else:  # the model's own init (models/vit.py:init_vit_params)
            norm = torch.nn.LayerNorm(384, eps=EPS).cuda()
            mlp = Mlp(ViTConfig(mlp_ratio=hidden / 384))
            gen = torch.Generator().manual_seed(3)
            with torch.no_grad():
                for lin in (mlp.fc1, mlp.fc2):
                    torch.nn.init.trunc_normal_(lin.weight, std=0.02, a=-0.04,
                                                b=0.04, generator=gen)
                    torch.nn.init.zeros_(lin.bias)
            mlp = mlp.cuda()
        for m in MLP_EDGE_M:
            check_mlp(norm, mlp, m, g)


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


def bwd_dyn_err(got, ref, dtype):
    """(max |err| of dq, dk, dv, within BWD_DYN_REL of the largest |ref|)."""
    errs = [(a - b).abs().max().item() for a, b in zip(got, ref)]
    scale = max(b.abs().max().item() for b in ref)
    return errs, max(errs) <= BWD_DYN_REL[dtype] * scale


def phase_bwd_kernel():
    """The flash backward vs its plain version; returns the max errors at
    the train bench's microbatch shapes (bf16, B*nh = 12, N = 3,601) and at
    the fp32 240px step's (f32, B*nh = 12, N = 901)."""
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for n in (37, 901, 3601, 14401):
            for bh in (6, 12, 18):
                q, k, v, do, out, lse = bwd_inputs(bh, n, dtype, seed=n + bh)
                got = flash_attention_bwd(q, k, v, out, lse, do, SCALE)
                again = flash_attention_bwd(q, k, v, out, lse, do, SCALE)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                ref = attention_bwd_plain(q, k, v, out, lse, do, SCALE)
                errs, ok = bwd_err(got, ref, dtype)
                rec = {"phase": "kernel_check", "kernel": "flash_attn_bwd",
                       "dtype": str(dtype).split(".")[1], "bh": bh, "n": n,
                       "max_abs_err": max(errs), "dq_err": errs[0],
                       "dk_err": errs[1], "dv_err": errs[2],
                       "max_abs_ref": max(r.abs().max().item() for r in ref),
                       "same_bits_twice": same,
                       "tol": (list(BWD_F32_TOL) if dtype == torch.float32
                               else f"{BWD_BF16_REL} x max|ref| per tensor")}
                emit(rec)
                check(ok, f"flash backward {rec}")
                check(same, f"flash backward bits differ between runs {rec}")
                if dtype == torch.bfloat16 and n == 3601 and bh == 12:
                    worst["flash_attn_bwd"] = rec["max_abs_err"]
                if dtype == torch.float32 and n == 901 and bh == 12:
                    worst["flash_attn_bwd_f32"] = rec["max_abs_err"]
                del q, k, v, do, out, lse, got, again, ref
    return worst


def phase_bwd_edges():
    """The f32 backward (flash_bwd_f32: 128-row blocks of two 64-row
    warpgroups, 32-row streamed tiles) at query counts around its tiles,
    B*nh = 1: the static entry, and the dynamic-bound one with key bounds
    around its tiles; each call twice, held to the same bits, dead keys'
    rows exact zeros."""
    f32 = torch.float32
    for n in BWD_EDGE_N:
        g = torch.Generator(device="cuda").manual_seed(n + 3)
        q, k, v, do = (torch.randn(1, 1, n, 64, generator=g, device="cuda")
                       for _ in range(4))
        out, lse = flash_attention(q, k, v, SCALE, return_lse=True)
        dsum = (do * out).sum(-1).reshape(1, n)
        calls = [("static", n, lambda: flash_attention_bwd(
            q, k, v, out, lse, do, SCALE), lambda: attention_bwd_plain(
                q, k, v, out, lse, do, SCALE))]
        for valid in sorted({0, 1, 63, 64, 65, n}):
            if valid <= n:
                calls.append(("dyn", valid, functools.partial(
                    flash_attention_bwd_dyn, q, do, lse, dsum, k, v, SCALE,
                    valid), functools.partial(
                        attention_bwd_dyn_plain, q, do, lse, dsum, k, v,
                        SCALE, valid)))
        for entry, valid, fn, plain in calls:
            got, again = fn(), fn()
            torch.cuda.synchronize()
            errs, ok = bwd_err(got, plain(), f32)
            tail = max(t[:, :, valid:].abs().max().item() if valid < n
                       else 0.0 for t in got[1:])
            rec = {"phase": "kernel_check", "kernel": "flash_attn_bwd_edges",
                   "dtype": "float32", "entry": entry, "bh": 1, "n": n,
                   "valid": valid, "max_abs_err": max(errs),
                   "dead_key_grad_max": tail,
                   "same_bits_twice": all(torch.equal(a, b)
                                          for a, b in zip(got, again)),
                   "tol": list(BWD_F32_TOL)}
            emit(rec)
            check(ok, f"f32 backward edge {rec}")
            check(tail == 0.0, f"f32 backward edge: dead keys not zero {rec}")
            check(rec["same_bits_twice"], f"f32 backward edge bits {rec}")


def counts():
    """(flash forward, fused MLP, bf16 backward, f32 backward) launches."""
    c = all_counts()
    return (c["flash_attn_fwd"], c["fused_ln_mlp"], c["flash_attn_bwd"],
            c["flash_attn_bwd_f32"])


def zero_counts():
    flash_attention.launches = flash_attention.launches_f32 = 0
    fused_ln_mlp_residual.launches = 0
    flash_attention_bwd.launches = flash_attention_bwd.launches_f32 = 0
    flash_attention_with_lse_dyn.launches = 0
    flash_attention_bwd_dyn.launches = 0
    flash_attention_bwd_dyn.launches_f32 = 0


def all_counts():
    """Launch counts of every kernel, by kernel name: the backward's bf16
    kernel per entry (kernel 3, kernel 6) and its f32 kernel over both; the
    forward entry's launches in both dtypes, and of them the f32 kernel's
    (flash_fwd_f32)."""
    bwd, dyn = flash_attention_bwd, flash_attention_bwd_dyn
    return {"flash_attn_fwd": flash_attention.launches,
            "flash_attn_fwd_f32": flash_attention.launches_f32,
            "fused_ln_mlp": fused_ln_mlp_residual.launches,
            "flash_attn_bwd": bwd.launches - bwd.launches_f32,
            "flash_attn_bwd_f32": bwd.launches_f32 + dyn.launches_f32,
            "flash_attn_fwd_dyn": flash_attention_with_lse_dyn.launches,
            "flash_attn_bwd_dyn": dyn.launches - dyn.launches_f32}


def sp_want(fwd_dyn, bwd_dyn=0, bwd_f32=0):
    """The counts an SP run must show: dyn entries only (the backward's
    bf16 or f32 kernel)."""
    return {"flash_attn_fwd": 0, "flash_attn_fwd_f32": 0, "fused_ln_mlp": 0,
            "flash_attn_bwd": 0, "flash_attn_bwd_f32": bwd_f32,
            "flash_attn_fwd_dyn": fwd_dyn,
            "flash_attn_bwd_dyn": bwd_dyn}


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
            d_flash, d_mlp = [a - b for a, b in zip(counts(), before)][:2]
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
            near = near_ties(logp).reshape(3, 60, 60)
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
          "total_flash_bwd_launches": total[2] + total[3]})
    check(total[2] + total[3] == 0, "predict launched a backward kernel")
    check(total[0] > 0 and total[1] > 0, "a kernel was never launched")
    return {"flash_attn_fwd": total[0], "fused_ln_mlp": total[1]}, per_call


def trainables(vit, head, frozen):
    return list(head.parameters()) + ([] if frozen else list(vit.parameters()))


def train_run(model, frozen, precision, res, batch, accum, steps, want,
              seed):
    """``steps`` train steps through make_train_step; checks the launches
    of every step against ``want`` (flash fwd, fused MLP, flash bwd in bf16
    and in f32), a
    finite loss, that the trained parameters moved and that a frozen
    backbone kept its bits.  Returns the last step's loss and every
    step's host time."""
    vit, head = model.model.dino, model.model.clf
    cdt = torch.bfloat16 if precision == "bf16" else None
    opt = make_optimizer("adam", 1e-5)
    opt_state = init_opt_state(opt, vit, head, frozen)
    step = make_train_step(model.cfg, model.head, 7, opt, frozen,
                           compute_dtype=cdt, accum_steps=accum,
                           backbone=model.backbone, **model._head_kwargs)
    rs = np.random.RandomState(seed)
    out = res // 8
    labels = torch.from_numpy(rs.randint(0, 7, (batch, out * out)).astype(
        np.int32)).cuda()
    imgs = torch.from_numpy(rs.randint(0, 255, (batch, res, res, 3)).astype(
        np.uint8)).cuda()
    before_p = [p.detach().clone() for p in trainables(vit, head, frozen)]
    before_bb = [p.detach().clone() for p in vit.parameters()]
    times = []
    for i in range(steps):
        before = counts()
        t0 = time.perf_counter()
        loss, cm = step(vit, head, opt_state, imgs, labels)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        got = [a - b for a, b in zip(counts(), before)]
        rec = {"phase": "train_path", "frozen": frozen,
               "precision": precision, "res": res, "batch": batch,
               "accum_steps": accum, "step": i, "loss": loss.item(),
               "cm_total": int(cm.sum()), "flash_launches": got[0],
               "fused_mlp_launches": got[1], "flash_bwd_launches": got[2],
               "flash_bwd_f32_launches": got[3], "host_s": dt}
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
    return loss, times


def phase_train_path():
    """make_train_step on the card; returns the phase's launch counts, the
    backward launches per unfrozen bf16 step and that step's host frames/s
    (the median of the steps after the first)."""
    zero_counts()
    model = DINOSeg(head="mlp", n_blocks=3, n_classes=7, precision="bf16",
                    random_init=True, seed=1, freeze_backbone=False)
    # unfrozen bf16 at the train bench's shapes: 8 microbatches x 3 blocks
    _, times = train_run(model, False, "bf16", 480, 16, 8, 3,
                         (24, 0, 24, 0), seed=2)
    model.freeze_bb()
    train_run(model, True, "bf16", 480, 16, 8, 1, (24, 24, 0, 0), seed=3)
    model.unfreeze_bb()
    cpu = DINOSeg(head="mlp", n_blocks=3, n_classes=7, precision="fp32",
                  random_init=True, device="cpu", freeze_backbone=False)
    cpu.load_state_dict({k: v.cpu() for k, v in
                         model.model.state_dict().items()})
    loss, _ = train_run(model, False, "fp32", 240, 2, 1, 1, (3, 0, 0, 3),
                        seed=4)
    total = all_counts()
    emit({"phase": "train_path", "launches": total})
    check(total["flash_attn_bwd"] > 0 and total["flash_attn_bwd_f32"] > 0,
          "a backward kernel was never launched")
    phase_train_cpu_reference(model, cpu, loss.item(), seed=4)
    return total, 24, 16 / float(np.median(times[1:]))


def phase_train_cpu_reference(card, cpu, card_loss, seed, phase="train",
                              floor_rel=0.0):
    """The card's fp32 240px step (just taken, gradients still in .grad)
    against the same step on the CPU from the same weights and batch (the
    model's head and backbone).  Each gradient leaf is held against
    max(its own max |g|, ``floor_rel`` x the model's largest |g|)."""
    vit, head = cpu.model.dino, cpu.model.clf
    opt = make_optimizer("adam", 1e-5)
    step = make_train_step(cpu.cfg, cpu.head, 7, opt, False,
                           backbone=cpu.backbone, **cpu._head_kwargs)
    rs = np.random.RandomState(seed)
    labels = torch.from_numpy(rs.randint(0, 7, (2, 900)).astype(np.int32))
    imgs = torch.from_numpy(rs.randint(0, 255, (2, 240, 240, 3)).astype(
        np.uint8))
    loss, _ = step(vit, head, init_opt_state(opt, vit, head, False), imgs,
                   labels)
    worst, worst_name, ok, diffs = 0.0, None, True, {}
    card_params = dict(card.model.named_parameters())
    floor = floor_rel * max(p.grad.abs().max().item()
                            for p in cpu.model.parameters()
                            if p.grad is not None)
    for name, p in cpu.model.named_parameters():
        g_card = card_params[name].grad
        check(g_card is not None, f"no gradient reached {name} on the card")
        diffs[name] = (g_card.cpu() - p.grad).abs().max().item()
        rel = diffs[name] / max(p.grad.abs().max().item(), floor, 1e-30)
        ok &= rel <= STEP_GRAD_REL
        if rel >= worst:
            worst, worst_name = rel, name
    rec = {"phase": f"{phase}_cpu_reference", "res": 240,
           "precision": "fp32", "head": cpu.head, "backbone": cpu.backbone,
           "loss_card": card_loss, "loss_cpu": loss.item(),
           "grad_max_abs_diff": diffs,
           "grad_worst_rel_diff": worst, "grad_worst_leaf": worst_name,
           "tol": {"loss_rtol": STEP_LOSS_RTOL,
                   "grad_rel_per_leaf": STEP_GRAD_REL,
                   "grad_floor_rel": floor_rel}}
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

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, scale=SCALE)

    rows["flash_attn_fwd"] = {
        **kernel_times(lambda: flash_attention(q, k, v, SCALE)),
        "plain_ms": median_ms(lambda: attention_plain(q, k, v, SCALE)),
        **library_times(sdpa),
        "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes,
        "launches_per_predict": per_call["bf16"][0]}
    rows["flash_attn_fwd"]["library_kernels"] = bench.device_breakdown(
        sdpa, 1, rows["flash_attn_fwd"]["library_ms"])["kernels"]
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
    # the eager bf16 composition on cuBLAS, its bf16 operands cast beforehand
    fc1, fc2, norm = block.mlp.fc1, block.mlp.fc2, block.norm2
    cw = [t.detach().to(torch.bfloat16) for t in (
        norm.weight, norm.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias)]

    def composition():
        y = F.layer_norm(x, (d,), cw[0], cw[1], EPS)
        y = F.gelu(F.linear(y, cw[2], cw[3]))
        return x + F.linear(y, cw[4], cw[5])

    with torch.no_grad():
        rows["fused_ln_mlp"] = {
            **kernel_times(lambda: fused_ln_mlp_residual(
                block.norm2, block.mlp, x, EPS)),
            "plain_ms": median_ms(lambda: fused_ln_mlp_residual_plain(
                block.norm2, block.mlp, x, EPS)),
            "library_ms": None, "composition_ms": median_ms(composition),
            "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes,
            "launches_per_predict": per_call["bf16"][1]}
        for m_one in (3601,):  # one frame: 57 row blocks
            x1 = x[:m_one]
            rows["fused_ln_mlp"][f"ms_m{m_one}"] = graph_ms(
                lambda: fused_ln_mlp_residual(block.norm2, block.mlp, x1,
                                              EPS))
    rows["flash_attn_bwd"] = dict(bwd_row(12, 3601, torch.bfloat16, seed=8),
                                  launches_per_train_step=bwd_per_step)
    for name, row in rows.items():
        shape = ("480px train microbatch (2 x 6 heads)"
                 if name == "flash_attn_bwd" else "480px batch 3")
        emit(dict({"phase": "timing", "kernel": name, "shape": shape,
                   "kernel_ms": row["ms"]}, **row))
    for n in (901, 3601):
        row = dict(bwd_row(12, n, torch.float32, seed=13),
                   shape=f"fp32 train step (2 x 6 heads, N = {n})")
        emit(dict({"phase": "timing", "kernel": "flash_attn_bwd_f32",
                   "kernel_ms": row["ms"]}, **row))
        if n == 901:
            rows["flash_attn_bwd_f32"] = dict(row, launches_per_train_step=3)
    return rows


def library_times(fn):
    """{"library_ms", "library_ms_eager"}: one library call's time as
    kernel_times takes a kernel's, a graph replay and an eager burst."""
    t = kernel_times(fn)
    return {"library_ms": t["ms"], "library_ms_eager": t["ms_eager"]}


def sdpa_bwd_times(q, k, v, do):
    """SDPA's backward on these inputs, timed as kernel_times times the
    kernel's: the graph replay of its forward and backward together less
    that of its forward (autograd runs a backward on its forward's stream,
    so a backward alone cannot be captured), and an eager burst of the
    backward alone."""
    def fwd():
        # leaves made in the call: their gradient nodes then belong to the
        # capturing stream, not to the stream the graph's inputs came from
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        return leaves, F.scaled_dot_product_attention(*leaves, scale=SCALE)

    def fwd_bwd():
        leaves, out = fwd()
        return torch.autograd.grad(out, leaves, do)
    out = fwd()[1]
    return {"library_ms": graph_ms(fwd_bwd) - graph_ms(fwd),
            "library_ms_eager": median_ms(
                lambda: out.backward(do, retain_graph=True))}


def bwd_row(bh, n, dtype, seed):
    """The flash backward at (B*nh, N) in ``dtype`` (f32: flash_bwd_f32,
    three TF32 passes per product): kernel (graph replay and eager), plain
    version and SDPA's backward on the same inputs; the bound (f32 by three
    TF32 passes, and on the f32 CUDA cores beside it)."""
    q, k, v, do, out, lse = bwd_inputs(bh, n, dtype, seed)
    b, nh, _, hd = q.shape
    flops = 10 * n * n * hd * b * nh
    # q, k, v, dO in; lse, D in (f32); dq, dk, dv out (f32)
    nbytes = (4 * q.element_size() + 2 * 4 / hd + 3 * 4) * b * nh * n * hd
    f32 = dtype == torch.float32
    bnd, by = bound_ms(flops, nbytes, "tf32" if f32 else dtype)
    row = {**kernel_times(lambda: flash_attention_bwd(q, k, v, out, lse, do,
                                                      SCALE)),
           "plain_ms": median_ms(lambda: attention_bwd_plain(
               q, k, v, out, lse, do, SCALE)),
           **sdpa_bwd_times(q, k, v, do),
           "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes}
    if f32:
        row["bound_f32_cores_ms"] = bound_ms(flops, nbytes, torch.float32)[0]
    return row


def sp_shapes(n_real, d):
    """(n_local, sorted distinct bounds) of a ring of ``d`` ranks: a full
    shard, the last shard's bound, one key, none."""
    n_local = -(-n_real // d)
    last = n_real - (d - 1) * n_local
    return n_local, sorted({n_local, last, 1, 0}, reverse=True)


def phase_sp_kernels():
    """Kernels 5 and 6 vs their plain versions at the per-hop shapes of a
    960px ring over 1, 2 and 4 ranks; returns the max errors at the 2-rank
    shape (bf16, B*nh = 12, valid 7,200)."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = FLASH_TOL[dtype]
        for d in (1, 2, 4):
            n, bounds = sp_shapes(SP_N_REAL, d)
            for bh in (6, 12):
                q, k, v = flash_inputs(bh, n, dtype, seed=n + bh)
                g = torch.Generator(device="cuda").manual_seed(n + bh + 1)
                do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
                full = None
                for valid in bounds:
                    out, lse = flash_attention_with_lse_dyn(q, k, v, SCALE,
                                                            valid)
                    torch.cuda.synchronize()
                    ref, ref_lse = attention_dyn_plain(q, k, v, SCALE, valid)
                    err = (out.float() - ref.float()).abs()
                    rec = {"phase": "sp_kernels",
                           "kernel": "flash_attn_fwd_dyn",
                           "dtype": str(dtype).split(".")[1], "ring": d,
                           "bh": bh, "n_local": n, "valid": valid,
                           "max_abs_err": err.max().item(),
                           "lse_max_abs_err":
                               (lse - ref_lse).abs().max().item(),
                           "lse_max": lse.max().item(),
                           "tol": [atol, rtol, LSE_ATOL]}
                    emit(rec)
                    check(bool(torch.isfinite(out).all()), f"non-finite {rec}")
                    if valid:
                        check(bool((err <= atol + rtol * ref.float().abs()
                                    ).all()), f"dyn forward {rec}")
                        check(rec["lse_max_abs_err"] <= LSE_ATOL,
                              f"dyn lse {rec}")
                    else:
                        check(rec["lse_max"] <= -1e29, f"dyn lse at 0 {rec}")
                    # the backward's global lse and D: this bound's forward
                    # (the full bound's when no key is valid)
                    if full is None:
                        full = (ref_lse, ref)
                    lse_g, out_g = (ref_lse, ref) if valid else full
                    dsum = (do.float() * out_g.float()).sum(-1).reshape(
                        bh, n)
                    got = flash_attention_bwd_dyn(q, do, lse_g, dsum, k, v,
                                                  SCALE, valid)
                    again = flash_attention_bwd_dyn(q, do, lse_g, dsum, k, v,
                                                    SCALE, valid)
                    torch.cuda.synchronize()
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    want = attention_bwd_dyn_plain(q, do, lse_g, dsum, k, v,
                                                   SCALE, valid)
                    b_errs, ok = bwd_dyn_err(got, want, dtype)
                    tail = max(t[:, :, valid:].abs().max().item()
                               if valid < n else 0.0 for t in got[1:])
                    rec = {"phase": "sp_kernels",
                           "kernel": "flash_attn_bwd_dyn",
                           "dtype": str(dtype).split(".")[1], "ring": d,
                           "bh": bh, "n_local": n, "valid": valid,
                           "max_abs_err": max(b_errs), "dq_err": b_errs[0],
                           "dk_err": b_errs[1], "dv_err": b_errs[2],
                           "max_abs_ref": max(r.abs().max().item()
                                              for r in want),
                           "dead_key_grad_max": tail,
                           "same_bits_twice": same,
                           "tol": f"{BWD_DYN_REL[dtype]} x max|ref| of the "
                                  f"hop"}
                    emit(rec)
                    check(ok, f"dyn backward {rec}")
                    check(same, f"dyn backward bits differ between runs {rec}")
                    check(tail == 0.0, f"dead keys' dk/dv not zero {rec}")
                    check(all(bool(torch.isfinite(t).all()) for t in got),
                          f"non-finite dyn backward {rec}")
                    if (dtype == torch.bfloat16 and d == 2 and bh == 12
                            and valid == n - 1):
                        errs["flash_attn_fwd_dyn"] = err.max().item()
                        errs["flash_attn_bwd_dyn"] = max(b_errs)
                    del out, lse, ref, ref_lse, err, got, again, want
                del q, k, v, do, full
    return errs


def near_ties(logp, margin=MARGIN):
    """Rows whose top-2 log-prob gap is below ``margin``."""
    top2 = torch.topk(logp.float(), 2, dim=-1).values
    return top2[:, 0] - top2[:, 1] < margin


def labels_agree(got, want, near, out_size):
    """(patches that differ, of them away from near ties) of two
    (B, 480, 480) label maps, read at one pixel per patch."""
    f = 480 // out_size
    diff = torch.from_numpy(got[:, ::f, ::f] != want[:, ::f, ::f])
    near = near.reshape(diff.shape)
    return int(diff.sum()), int((diff & ~near).sum())


def counted(fn):
    """(fn(), the launch counts of the call): every count zeroed just
    before and read just after."""
    zero_counts()
    result = fn()
    torch.cuda.synchronize()
    return result, all_counts()


def add_counts(total, got):
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def phase_sp_world1(model, frames2):
    """SP in a world of one over NCCL: predict_batch at 960px, batch 1 and
    2, fp32 and bf16, against the port's predict_batch, then one SP
    finetune step against make_train_step; returns the launch counts of the
    SP calls."""
    store = tempfile.mkdtemp(prefix="dtt_sp_")
    pdist.init_distributed_mode("nccl", f"file://{store}/store", 1, 0)
    total = {}
    try:
        model.set_resolution(SP_RES)
        for prec in ("fp32", "bf16"):
            for batch in (1, 2):
                imgs = frames2[:batch]
                t0 = time.perf_counter()
                out, got = counted(lambda: model.predict_batch(
                    imgs, precision=prec, parallelism="sp"))
                dt = time.perf_counter() - t0
                add_counts(total, got)
                check(out.shape == (batch, 480, 480) and out.dtype == np.int32,
                      "SP predict_batch output")
                check(0 <= out.min() and out.max() < 7, "SP labels range")
                check(got == sp_want(3),
                      f"SP predict launches {got}, want 3 of kernel 5")
                ref = model.predict_batch(imgs, precision=prec)
                logp = model.log_probs(torch.from_numpy(imgs).cuda(),
                                       precision=prec).cpu()
                n_diff, n_far = labels_agree(out, ref, near_ties(logp),
                                             SP_RES // 8)
                rec = {"phase": "sp_path", "world": 1, "backend": "nccl",
                       "call": "predict_batch", "res": SP_RES,
                       "batch": batch, "precision": prec, "launches": got,
                       "patches_differing": n_diff,
                       "agreement": 1 - n_diff / (batch * (SP_N_REAL - 1)),
                       "host_s": dt}
                emit(rec)
                if prec == "fp32":
                    check(n_far == 0, f"SP fp32 labels differ away from "
                                      f"near ties {rec}")
        check_sp_step(SP_RES, "fp32", np.random.RandomState(7), total, 1,
                      "nccl")
        return total
    finally:
        dist.destroy_process_group()
        model.set_resolution(480)


def start_ranks(kind, world, backend):
    """Start the rank processes of phase 6 (``kind`` 'sp'), 13 ('dp'), 14
    ('tp') or 15 ('pp'):
    this script with ``--<kind>-rank R --<kind>-world W --<kind>-store
    PATH --<kind>-backend B`` (the library is built, so they load it).
    Returns (processes, their start time, the store's path)."""
    store = os.path.join(tempfile.mkdtemp(prefix=f"dtt_{kind}_"), "store")
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), f"--{kind}-rank", str(r),
         f"--{kind}-world", str(world), f"--{kind}-store", store,
         f"--{kind}-backend", backend],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    return procs, time.perf_counter(), store


def join_ranks(started, kind, timeout):
    """Wait for the rank processes (each must exit 0 within ``timeout``
    seconds of the start, and end on its ``<kind>_rank_ok`` summary);
    re-emit their records with their rank.  Returns (the summaries in rank
    order, every rank's records)."""
    procs, t0, _ = started
    outs = []
    try:
        for p in procs:
            left = max(1.0, timeout - (time.perf_counter() - t0))
            outs.append(p.communicate(timeout=left))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    summaries, records = [], []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
        for rec in lines:
            emit(dict(rec, rank=r))
        records += lines
        check(p.returncode == 0, f"{kind} rank {r} exited {p.returncode}: "
                                 f"{err[-3000:]}")
        check(lines and lines[-1].get(f"{kind}_rank_ok") is True,
              f"{kind} rank {r} summary")
        summaries.append(lines[-1])
    return summaries, records


def join_sp_ranks(started):
    """Wait for phase 6's ranks; return the summed launch counts of their
    SP runs."""
    total = {}
    for summary in join_ranks(started, "sp", SP_RANK_TIMEOUT)[0]:
        add_counts(total, summary["launches"])
    return total


def _grad_report(params, ref_params, tol):
    """(worst relative gradient difference, its leaf, all within ``tol``)
    of two models' .grad, leaf by leaf, each against the leaf's max |g|."""
    worst, worst_name, ok = 0.0, None, True
    for (name, p), (_, r) in zip(params, ref_params):
        check(p.grad is not None and r.grad is not None, f"no grad {name}")
        rel = ((p.grad - r.grad).abs().max().item()
               / max(r.grad.abs().max().item(), 1e-30))
        ok &= rel <= tol
        if rel >= worst:
            worst, worst_name = rel, name
    return worst, worst_name, ok


def sp_model(prec):
    """The SP checks' model: random ViT-S/8 weights from seed 5, 3 blocks,
    MLP head, 7 classes, backbone trainable."""
    return DINOSeg(head="mlp", n_blocks=3, n_classes=7, precision=prec,
                   random_init=True, seed=5, freeze_backbone=False)


def one_step(prec, imgs, labels, make_step):
    """One Adam 1e-5 step of ``make_step(cfg, optimizer, compute_dtype)``
    on a fresh sp_model: (the model, its gradients in .grad; loss; cm)."""
    m = sp_model(prec)
    vit, head = m.model.dino, m.model.clf
    opt = make_optimizer("adam", 1e-5)
    step = make_step(m.cfg, opt,
                     torch.bfloat16 if prec == "bf16" else None)
    loss, cm = step(vit, head, init_opt_state(opt, vit, head, False), imgs,
                    labels)
    return m, loss, cm


@contextlib.contextmanager
def head_relu(record=None, replay=None, rows=None):
    """torch.relu as the MLP head calls it (the ViT calls none; a ResNet
    backbone does too).  ``record``, a list, gets each call's mask (x > 0)
    over the single-device step's patch rows.  ``replay``, such a list,
    sets each call's mask on an SP step's local token rows, ``rows`` =
    (batch, patches per image, world size, rank): a patch row takes the
    recorded choice, the CLS and padding rows (loss weight 0) their own;
    with ``rows`` None each call takes the recorded mask whole (a step of
    the same shapes on another device).  Yields the list of units per call
    whose own choice differed.  Calls past the replay's take their own
    choices (an eval pass after a replayed step)."""
    real, calls, flips = torch.relu, iter(replay or ()), []

    def relu(x):
        own = x > 0
        if record is not None:
            record.append(own)
            return real(x)
        mask = next(calls, None)
        if mask is None:  # the replay is used up: own choices after it
            return real(x)
        if rows is None:
            mask = mask.to(x.device)
            flips.append(int((mask != own).sum()))
            return x * mask.to(x.dtype)
        b, n_patches, d, me = rows
        n_local = x.shape[0] // b
        pos = me * n_local + torch.arange(n_local, device=x.device)
        live = ((pos >= 1) & (pos <= n_patches)).repeat(b)
        src = (torch.arange(b, device=x.device)[:, None] * n_patches
               + pos[None, :] - 1).reshape(-1)
        recorded, mask = mask, own.clone()
        mask[live] = recorded[src[live]]
        flips.append(int((mask != own).sum()))
        return x * mask.to(x.dtype)

    torch.relu = relu
    try:
        yield flips
    finally:
        torch.relu = real


def check_sp_step(res, prec, rs, total, world, backend):
    """One SP finetune step (batch 2 from ``rs``) against make_train_step
    from the same weights and batch; adds its launch counts to ``total``.
    fp32: loss rtol STEP_LOSS_RTOL, cm equal except near-tie patches, and
    each gradient leaf within STEP_GRAD_REL of its max, with the head's
    ReLU choices replayed from the single-device step (head_relu).  bf16:
    finite loss within SP_BF16_LOSS_RTOL."""
    d, out = world, res // 8
    imgs = torch.from_numpy(rs.randint(0, 255, (2, res, res, 3)).astype(
        np.uint8)).cuda()
    labels = torch.from_numpy(rs.randint(0, 7, (2, out * out)).astype(
        np.int32)).cuda()

    def single(accum):
        return lambda cfg, opt, cdt: make_train_step(
            cfg, "mlp", 7, opt, False, compute_dtype=cdt, accum_steps=accum)

    masks = [] if prec == "fp32" else None
    with (head_relu(record=masks) if masks is not None
          else contextlib.nullcontext()):
        ref_m, ref_loss, ref_cm = one_step(prec, imgs, labels, single(1))
    with torch.no_grad():
        near = near_ties(ref_m.forward(imgs.cpu().numpy()))
    t0 = time.perf_counter()
    with (head_relu(replay=masks, rows=(2, out * out, d, dist.get_rank()))
          if masks is not None else contextlib.nullcontext()) as flips:
        (sp_m, loss, cm), got = counted(lambda: one_step(
            prec, imgs, labels, lambda cfg, opt, cdt: make_sp_train_step(
                cfg, "mlp", 7, opt, compute_dtype=cdt)))
    dt = time.perf_counter() - t0
    add_counts(total, got)
    rec = {"phase": "sp_path", "world": d, "backend": backend,
           "call": "train_step", "res": res, "batch": 2, "precision": prec,
           "loss": loss.item(), "loss_single_device": ref_loss.item(),
           "cm_abs_diff": int((cm - ref_cm).abs().sum()),
           "near_tie_patches": int(near.sum()), "launches": got,
           "host_s": dt}
    tol = None
    if prec == "fp32":
        tol = STEP_GRAD_REL
        rec["head_relu_units_replayed"] = flips
        if d > 1:  # the float32 gradient's own spread on this batch
            acc_m = one_step(prec, imgs, labels, single(2))[0]
            rec["grad_worst_rel_diff_regrouped_single_device"] = _grad_report(
                acc_m.model.named_parameters(),
                ref_m.model.named_parameters(), 1.0)[:2]
    worst, leaf, grads_ok = _grad_report(sp_m.model.named_parameters(),
                                         ref_m.model.named_parameters(),
                                         tol or 1.0)
    rec.update(grad_worst_rel_diff=worst, grad_worst_leaf=leaf, grad_tol=tol)
    emit(rec)
    want = (sp_want(3 * d, bwd_f32=3 * d) if prec == "fp32"
            else sp_want(3 * d, bwd_dyn=3 * d))
    check(got == want, f"SP step launches {rec}")
    check(bool(torch.isfinite(loss)), f"non-finite SP loss {rec}")
    if prec == "fp32":
        check(abs(loss.item() - ref_loss.item())
              <= STEP_LOSS_RTOL * abs(ref_loss.item()), f"SP loss {rec}")
        check(rec["cm_abs_diff"] <= 2 * rec["near_tie_patches"],
              f"SP confusion matrix {rec}")
        check(grads_ok, f"SP gradients {rec}")
    else:
        check(abs(loss.item() - ref_loss.item())
              <= SP_BF16_LOSS_RTOL * abs(ref_loss.item()),
              f"SP bf16 loss {rec}")


def sp_rank_main(rank, world, store, backend):
    """One rank of phase 6: gloo over host-staged collectives with the
    kernels on a shared card, or NCCL with one card per rank.  Prints JSON
    records, the last one its summary."""
    pdist.init_distributed_mode(backend, f"file://{store}", world, rank)
    total = {}
    rs = np.random.RandomState(6)
    frame = rs.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    model = sp_model("fp32")
    model.set_resolution(SP_RES)
    sp, got = counted(lambda: model.predict_batch(
        frame[None], precision="fp32", parallelism="sp"))
    add_counts(total, got)
    ref = model.predict_batch(frame[None], precision="fp32")
    logp = model.log_probs(torch.from_numpy(frame[None]).cuda(),
                           precision="fp32").cpu()
    n_diff, n_far = labels_agree(sp, ref, near_ties(logp), SP_RES // 8)
    rec = {"phase": "sp_path", "world": world, "backend": backend,
           "call": "predict", "res": SP_RES, "precision": "fp32",
           "launches": got, "patches_differing": n_diff}
    emit(rec)
    check(got == sp_want(3 * world), f"SP predict launches {rec}")
    check(n_far == 0, f"SP labels differ away from near ties {rec}")
    for res, prec in ((240, "fp32"), (SP_RES, "fp32"), (SP_RES, "bf16")):
        check_sp_step(res, prec, rs, total, world, backend)
    dist.destroy_process_group()
    emit({"sp_rank_ok": True, "rank": rank, "launches": total})


def sp_cards_main(world, card):
    """Phase 6's rank checks with one rank per card over NCCL."""
    check(torch.cuda.device_count() >= world,
          f"--sp-world {world} needs {world} cards, found "
          f"{torch.cuda.device_count()}")
    emit({"phase": "device", "names": [torch.cuda.get_device_name(i)
                                       for i in range(world)],
          "nvidia_smi": card, "torch": torch.__version__})
    _build.library()
    total = join_sp_ranks(start_ranks("sp", world, "nccl"))
    emit({"phase": "sp_path", "world": world, "backend": "nccl",
          "rank_launches_summed": total})
    check(total["flash_attn_bwd_dyn"] > 0, "an SP kernel was never launched")
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def phase_chunked(model, frame):
    """fp32 predict at 1624px (N = 41,210): the streaming forward where
    dino_tpu runs _flash_kernel_chunked, three launches, no LSE; then the
    kernel vs its plain version at that N.  Returns (launches, max err)."""
    calls = []
    real = tatt._flash_fwd

    def spy(q, k, v, scale, return_lse):
        calls.append((str(q.dtype), return_lse, q.shape[2]))
        return real(q, k, v, scale, return_lse)

    model.set_resolution(CHUNKED_RES)
    zero_counts()
    tatt._flash_fwd = spy
    try:
        t0 = time.perf_counter()
        out = model.predict(frame, precision="fp32")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        tatt._flash_fwd = real
        model.set_resolution(480)
    got = all_counts()
    n = (CHUNKED_RES // 8) ** 2 + 1
    emit({"phase": "chunked_path", "call": "predict", "res": CHUNKED_RES,
          "precision": "fp32", "n_tokens": n, "shape": list(out.shape),
          "launches": got,
          "forward_calls": calls, "host_s": dt})
    side = (CHUNKED_RES // 8) * (480 // (CHUNKED_RES // 8))  # kron factor 2
    check(out.shape == (side, side) and 0 <= out.min() and out.max() < 7,
          f"{CHUNKED_RES}px predict output {out.shape}")
    check(got["flash_attn_fwd"] == 3 and calls == [
        ("torch.float32", False, n)] * 3,
          f"1624px fp32 predict: {calls}, want 3 f32 forwards, no LSE")
    q, k, v = flash_inputs(6, n, torch.float32, seed=9)
    o = flash_attention(q, k, v, SCALE)
    torch.cuda.synchronize()
    ref, _ = attention_plain(q, k, v, SCALE)
    atol, rtol = FLASH_TOL[torch.float32]
    err = (o - ref).abs()
    rec = {"phase": "kernel_check", "kernel": "flash_attn_fwd_chunked",
           "dtype": "float32", "bh": 6, "n": n,
           "max_abs_err": err.max().item(), "tol": [atol, rtol]}
    emit(rec)
    check(bool((err <= atol + rtol * ref.abs()).all()), f"1624px flash {rec}")
    return got["flash_attn_fwd"], rec["max_abs_err"]


def f32_forward_row(res, burst):
    """The f32 forward at an fp32 predict's shape (1 x 6 heads, N tokens of
    ``res``): kernel, plain version, SDPA and the device kernels SDPA
    launches; bound by three TF32 passes, and on the f32 CUDA cores beside
    it."""
    n = (res // 8) ** 2 + 1
    q, k, v = flash_inputs(6, n, torch.float32, seed=10)
    b, nh, _, hd = q.shape
    flops, nbytes = 4 * n * n * hd * b * nh, 4 * b * nh * n * hd * 4
    bnd, by = bound_ms(flops, nbytes, "tf32")

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, scale=SCALE)

    row = {"ms": median_ms(lambda: flash_attention(q, k, v, SCALE), **burst),
           "plain_ms": median_ms(lambda: attention_plain(q, k, v, SCALE),
                                 **burst),
           "library_ms": median_ms(sdpa, **burst),
           "bound_ms": bnd, "bound_by": by,
           "bound_f32_cores_ms": bound_ms(flops, nbytes, torch.float32)[0],
           "flops": flops, "bytes": nbytes,
           "shape": f"{res}px fp32 predict (1 x 6 heads, N = {n})"}
    row["library_kernels"] = bench.device_breakdown(
        sdpa, 1, row["library_ms"])["kernels"]
    return row


def phase_timing_sp(launches):
    """Rows 4-6: the streaming forward at the 1624px shape (f32, B*nh = 6,
    N = 41,210, short bursts; and at the 960px fp32 predict's N = 14,401),
    the dynamic-bound kernels at the 2-rank 960px per-hop shape (bf16,
    B*nh = 12, N = 7,201, valid 7,200)."""
    rows = {}
    rows["flash_attn_fwd_chunked"] = dict(
        f32_forward_row(CHUNKED_RES, dict(rounds=3, burst=2, warmup=1)),
        launches_per_predict=launches["flash_attn_fwd_chunked"])
    emit(dict({"phase": "timing", "kernel": "flash_attn_fwd (f32)"},
              **f32_forward_row(SP_RES, dict(rounds=5, burst=3, warmup=1))))
    n_local, bounds = sp_shapes(SP_N_REAL, SP_WORLD)
    valid = bounds[1]
    q, k, v = flash_inputs(12, n_local, torch.bfloat16, seed=11)
    b, nh, _, hd = q.shape
    el = q.element_size()
    kv = [t[:, :, :valid].contiguous() for t in (k, v)]
    flops = 4 * n_local * valid * hd * b * nh
    nbytes = b * nh * ((2 * n_local + 2 * valid) * hd * el + n_local * 4)
    bnd, by = bound_ms(flops, nbytes, torch.bfloat16)
    shape = (f"2-rank 960px ring hop (2 x 6 heads, N = {n_local}, "
             f"valid {valid})")
    rows["flash_attn_fwd_dyn"] = {
        **kernel_times(lambda: flash_attention_with_lse_dyn(
            q, k, v, SCALE, valid)),
        "plain_ms": median_ms(lambda: attention_dyn_plain(q, k, v, SCALE,
                                                          valid)),
        **library_times(lambda: F.scaled_dot_product_attention(
            q, *kv, scale=SCALE)),
        "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes,
        "shape": shape}
    g = torch.Generator(device="cuda").manual_seed(12)
    do = torch.randn(q.shape, generator=g, device="cuda").to(torch.bfloat16)
    out, lse = attention_dyn_plain(q, k, v, SCALE, valid)
    dsum = (do.float() * out.float()).sum(-1).reshape(b * nh, n_local)
    flops = 10 * n_local * valid * hd * b * nh
    # q, dO, k, v (valid rows) in; lse, D in; dq, dk, dv (f32) out
    nbytes = b * nh * ((2 * n_local + 2 * valid) * hd * el
                       + 2 * n_local * 4 + 3 * n_local * hd * 4)
    bnd, by = bound_ms(flops, nbytes, torch.bfloat16)
    rows["flash_attn_bwd_dyn"] = {
        **kernel_times(lambda: flash_attention_bwd_dyn(
            q, do, lse, dsum, k, v, SCALE, valid)),
        "plain_ms": median_ms(lambda: attention_bwd_dyn_plain(
            q, do, lse, dsum, k, v, SCALE, valid)),
        **sdpa_bwd_times(q, *kv, do),
        "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes,
        "shape": shape}
    for name, row in rows.items():
        emit(dict({"phase": "timing", "kernel": name, "kernel_ms": row["ms"]},
                  **row))
    return rows


def phase_fp32_latency(model, frame):
    """Host wall time of one fp32 predict (frame in, labels out) at 480 and
    960px: the median of 5 calls after a warm-up call."""
    for res in (480, SP_RES):
        model.set_resolution(res)
        model.predict(frame, precision="fp32")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            model.predict(frame, precision="fp32")
            times.append((time.perf_counter() - t0) * 1e3)
        emit({"phase": "timing", "call": "predict", "precision": "fp32",
              "res": res, "p50_ms": float(np.median(times)), "ms": times})
    model.set_resolution(480)


def attention_twins(model):
    """(card fp32, CPU fp32, CPU bf16) copies of a card DINOSeg's
    weights."""
    sd = model.model.state_dict()
    kw = dict(head=model.head, n_blocks=model.n_blocks,
              n_classes=model.n_classes, random_init=True)
    twins = (DINOSeg(precision="fp32", **kw),
             DINOSeg(precision="fp32", device="cpu", **kw),
             DINOSeg(precision="bf16", device="cpu", **kw))
    for twin in twins:
        twin.load_state_dict({k: v.to(twin.device) for k, v in sd.items()})
    return twins


def attention_masks(n, grid, seed):
    """n binary region masks (n, grid, grid): n horizontal bands, each
    thinned at random."""
    rs = np.random.RandomState(seed)
    masks = np.zeros((n, grid, grid), np.float32)
    for i, rows in enumerate(np.array_split(np.arange(grid), n)):
        masks[i, rows] = rs.rand(len(rows), grid) > 0.2
    return masks


def inter_composition(model, img):
    """get_intermediate_layers(n=2) of a bf16 card DINOSeg as the API runs
    it, but with a gradient asked of the input, so that every block takes
    the MLP composition (mlp_residual) where the API takes the fused
    kernel; the attention stays the bf16 flash forward."""
    with torch.enable_grad(), matmul_ctx(torch.bfloat16):
        x = preprocess(model._frames(img), model.resolution)
        x = x.to(torch.bfloat16).requires_grad_()
        outs = get_intermediate_layers(model.model.dino, x, model.cfg, n=2)
    return np.stack([t.detach().float().cpu().numpy() for t in outs])


def attention_checks(model, twins, frame, masks, res=240):
    """The attention-map calls on the card against the port's own CPU run
    at ``res``: get_last_selfattention (full and CLS-row only, with and
    without ``masks``) and forward_mask on the card's bf16 ``model`` (which
    run f32: depth - 1 launches of the f32 forward, no fused MLP), and
    get_intermediate_layers(n=2) on the fp32 twin (depth f32 forwards) and
    on ``model`` (depth bf16 forwards and fused MLPs).  f32 outputs within
    ATTN_F32_REL of each output's largest magnitude, bf16 within FLASH_TOL's
    rates of it; returns the summed launch counts."""
    card32, cpu32, cpu16 = twins
    depth = model.n_blocks
    for m in (model, *twins):
        m.set_resolution(res)
    img = frame[None]
    glsa = "get_last_selfattention"
    calls = [
        (glsa, "full", lambda m: m.get_last_selfattention(img)),
        (glsa, "cls_only", lambda m: m.get_last_selfattention(
            img, cls_only=True)),
        (glsa, "full, masks", lambda m: m.get_last_selfattention(img, masks)),
        (glsa, "cls_only, masks", lambda m: m.get_last_selfattention(
            img, masks, cls_only=True)),
        ("forward_mask", "masks", lambda m: m.forward_mask(frame, masks)),
    ]
    def inter(m):
        return np.stack(m.get_intermediate_layers(img, n=2))

    runs = ([(name, form, "fp32", model, cpu32, fn, (depth - 1,) * 2 + (0,))
             for name, form, fn in calls]
            + [("get_intermediate_layers", "n=2", "fp32", card32, cpu32,
                inter, (depth, depth, 0)),
               ("get_intermediate_layers", "n=2", "bf16", model, cpu16,
                inter, (depth, 0, depth))])
    total = {}
    for name, form, prec, card, cpu, fn, want in runs:
        out, got = counted(lambda: fn(card))
        add_counts(total, got)
        ref = fn(cpu)
        err = np.abs(out - ref)
        top = float(np.abs(ref).max())
        if prec == "fp32":
            ok = err.max() <= ATTN_F32_REL * top
            tol = f"{ATTN_F32_REL} x max|ref|"
        else:
            atol, rtol = FLASH_TOL[torch.bfloat16]
            ok = err.max() <= atol + rtol * top
            tol = f"{atol} + {rtol} x max|ref|"
        have = (got["flash_attn_fwd"], got["flash_attn_fwd_f32"],
                got["fused_ln_mlp"])
        rec = {"phase": "attention_maps", "res": res, "call": name,
               "form": form, "precision": prec, "shape": list(out.shape),
               "max_abs_err_card_vs_cpu": float(err.max()), "max_abs_ref": top,
               "tol": tol, "flash_fwd_launches": have[0],
               "flash_fwd_f32_launches": have[1],
               "flash_fwd_bf16_launches": have[0] - have[1],
               "fused_mlp_launches": have[2]}
        if prec == "bf16":
            # the fused kernel's share of the error: the same call on the
            # card with the MLP as its composition, against the CPU and
            # against the fused run (a record, not a check)
            comp = inter_composition(card, img)
            rec["composition_max_abs_err_vs_cpu"] = float(
                np.abs(comp - ref).max())
            rec["fused_vs_composition_max_abs_err"] = float(
                np.abs(out - comp).max())
        emit(rec)
        check(bool(np.isfinite(out).all()), f"non-finite {rec}")
        check(out.shape == ref.shape, f"shape {rec}")
        check(ok, f"card {name} disagrees with the CPU {rec}")
        check(have == want, f"{name} launches {have}, want {want}")
    return total


def attention_large(model, frame, frames3):
    """480px batch 3: the full matrix's rows sum to 1 and its row 0 is the
    CLS-row call's, which process_attentions and the CLIs' compute
    functions take on the first frame; 960px: the CLS-row call and
    forward_mask with ATTN_960_MASKS masks, each adding under
    ATTN_PEAK_LIMIT bytes of peak memory.  Returns the summed launch
    counts."""
    total = {}
    model.set_resolution(480)
    full, got = counted(lambda: model.get_last_selfattention(frames3))
    add_counts(total, got)
    row, got = counted(lambda: model.get_last_selfattention(frames3,
                                                            cls_only=True))
    add_counts(total, got)
    rec = {"phase": "attention_maps", "res": 480, "batch": 3,
           "shape_full": list(full.shape), "shape_cls_only": list(row.shape),
           "row_sum_max_abs_err": float(np.abs(full.sum(-1) - 1).max()),
           "cls_row_max_abs_err": float(np.abs(row[:, :, 0]
                                               - full[:, :, 0]).max()),
           "tol": [ATTN_ROWSUM_ATOL, ATTN_CLS_ROW_ATOL]}
    del full
    emit(rec)
    check(rec["row_sum_max_abs_err"] <= ATTN_ROWSUM_ATOL, f"row sums {rec}")
    check(rec["cls_row_max_abs_err"] <= ATTN_CLS_ROW_ATOL, f"CLS row {rec}")
    maps = process_attentions(row[:1], resolution=480)
    kept = process_attentions(row[:1], threshold=0.6, resolution=480)
    check(maps.shape == kept.shape == (6, 60, 60), "process_attentions")
    first = frames3[0]
    viz, got = counted(lambda: overlay(model, first,
                                       resize_nearest(first, 480, 480)))
    add_counts(total, got)
    check(viz.shape == (480, 480, 3) and viz.dtype == np.uint8, "overlay")
    heads, got = counted(lambda: attention_maps(model, first))
    add_counts(total, got)
    err = float(np.abs(heads[:, ::8, ::8] - maps).max())
    emit({"phase": "attention_maps", "res": 480,
          "call": "cli.visualize_attention.attention_maps",
          "shape": list(heads.shape),
          "max_abs_err_vs_batch3_cls_row": err, "tol": ATTN_CLS_ROW_ATOL})
    check(heads.shape == (6, 480, 480) and err <= ATTN_CLS_ROW_ATOL,
          "attention_maps vs the CLS row")

    model.set_resolution(SP_RES)
    masks = attention_masks(ATTN_960_MASKS, SP_RES // 8, seed=2)
    n = SP_N_REAL
    for name, fn, shape in (
            ("get_last_selfattention cls_only",
             lambda: model.get_last_selfattention(frame[None],
                                                  cls_only=True),
             (1, 6, 1, n)),
            ("forward_mask", lambda: model.forward_mask(frame, masks),
             (ATTN_960_MASKS, 384))):
        zero_counts()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        add_counts(total, all_counts())
        rec = {"phase": "attention_maps", "res": SP_RES, "call": name,
               "n_tokens": n, "shape": list(out.shape),
               "peak_bytes_over_start": peak,
               "n_by_n_bytes": 6 * n * n * 4, "limit": ATTN_PEAK_LIMIT}
        emit(rec)
        check(out.shape == shape and bool(np.isfinite(out).all()),
              f"960px {rec}")
        check(peak < ATTN_PEAK_LIMIT, f"960px peak memory {rec}")
    model.set_resolution(480)
    return total


def stream_check(model, frames, batch_size, precision):
    """predict_stream over ``frames`` against predict_batch on the same
    padded batches: the same bits.  Returns the stream's launch counts."""
    padded = []
    for i in range(0, len(frames), batch_size):
        part = frames[i:i + batch_size]
        padded.append((np.concatenate([part, np.repeat(
            part[-1:], batch_size - len(part), axis=0)]), len(part)))
    outs, got = counted(lambda: list(model.predict_stream(
        iter(frames), batch_size=batch_size, precision=precision)))
    want = np.concatenate([model.predict_batch(b, precision=precision)[:n]
                           for b, n in padded])
    same = len(outs) == len(frames) and all(
        np.array_equal(a, b) for a, b in zip(outs, want))
    rec = {"phase": "attention_maps", "call": "predict_stream",
           "precision": precision, "res": model.resolution,
           "frames": len(frames), "batch_size": batch_size,
           "maps_equal_predict_batch": same, "launches": got}
    emit(rec)
    check(same, f"predict_stream != predict_batch {rec}")
    return got


def stream_rates(model, frames, batch_size, precision):
    """Host frames/s over a camera trace of STREAM_TIMED_FRAMES frames
    (``frames`` in a cycle): predict_stream, and a loop that stacks each
    batch of the same trace and calls predict_batch.  One untimed run of
    each first (it allocates the stream's pinned buffers, which the host
    allocator's cache then serves again), then STREAM_READINGS readings of
    each in turns.  Timing runs: their launches are not counted."""
    n = STREAM_TIMED_FRAMES

    def trace(count):
        return (frames[i % len(frames)] for i in range(count))

    def stream(count):
        for _ in model.predict_stream(trace(count), batch_size=batch_size,
                                      precision=precision):
            pass

    def loop(count):
        for s in range(0, count, batch_size):
            model.predict_batch([frames[i % len(frames)] for i in
                                 range(s, min(s + batch_size, count))],
                                precision=precision)

    stream(2 * batch_size)
    loop(2 * batch_size)
    fps = {"stream": [], "loop": []}
    for _ in range(STREAM_READINGS):
        for name, fn in (("stream", stream), ("loop", loop)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(n)
            fps[name].append(n / (time.perf_counter() - t0))
    emit({"phase": "attention_maps", "call": "predict_stream rates",
          "precision": precision, "res": model.resolution, "frames": n,
          "distinct_frames": len(frames), "batch_size": batch_size,
          "stream_host_fps": fps["stream"],
          "predict_batch_loop_host_fps": fps["loop"]})


def phase_attention_maps(model, frame, frames3):
    """Phase 8 on the main path's bf16 model: returns its launch counts
    (every count zeroed before each call and read after it)."""
    twins = attention_twins(model)
    total = attention_checks(model, twins, frame,
                             attention_masks(ATTN_MASKS, 30, seed=1))
    add_counts(total, attention_large(model, frame, frames3))
    frames = np.random.RandomState(3).randint(
        0, 256, (STREAM_FRAMES, 480, 640, 3)).astype(np.uint8)
    model.set_resolution(480)
    for prec in ("fp32", "bf16"):
        add_counts(total, stream_check(model, frames, STREAM_BATCH, prec))
    for prec in ("fp32", "bf16"):
        stream_rates(model, frames, STREAM_BATCH, prec)
    emit({"phase": "attention_maps", "launches": total,
          "flash_fwd_bf16_launches": (total["flash_attn_fwd"]
                                      - total["flash_attn_fwd_f32"])})
    for name in ("flash_attn_fwd_f32", "fused_ln_mlp"):
        check(total[name] > 0, f"{name} never launched by attention_maps")
    check(total["flash_attn_fwd"] > total["flash_attn_fwd_f32"],
          "the bf16 forward never launched by attention_maps")
    return total


# ---------------------------------------------------------------------------
# Phase 9: DINOSeg.fit and evaluate on an in-memory split
# ---------------------------------------------------------------------------

FIT_CLASSES = 7
FIT_FRAMES = {"train": 12, "val": 4, "test": 4}  # 480x640 frames per split
FIT_RES, FIT_BLOCKS = 480, 3
FIT_BATCH, FIT_ACCUM, FIT_SAMPLES, FIT_LR = 16, 8, 64, 1e-5
FIT_EPOCHS = 2
PARITY_RES, PARITY_BATCH, PARITY_SAMPLES = 240, 2, 4
# Adam moves an entry by up to lr a step whatever its gradient's size, so
# where card and CPU gradients differ in sign near 0 the parameters part by
# 2 * lr a step: at 1e-6 over the parity fit's 4 steps 8e-6, under
# FIT_PARAM_TOL's atol
PARITY_LR = 1e-6
FIT_LOSS_RTOL = 1e-5
FIT_PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
FIT_DEVICE = None  # the card
FIT_A_FPS = []  # phase 9 (a)'s train frames/s per epoch, beside phase 13's


def memory_split(n, seed, h=480, w=640, n_classes=FIT_CLASSES):
    """n colour-band frames as tests/test_train_smoke.py:_make_split makes
    them (vertical bands of class colours plus noise), with 7 classes at
    480x640: uint8 frames and int32 masks."""
    rs = np.random.RandomState(seed)
    colors = np.array([[200, 40, 40], [40, 200, 40], [40, 40, 200],
                       [200, 200, 40], [200, 40, 200], [40, 200, 200],
                       [120, 120, 120]], np.float32)
    frames = np.empty((n, h, w, 3), np.uint8)
    masks = np.empty((n, h, w), np.int32)
    for i in range(n):
        cuts = np.sort(rs.choice(np.arange(16, w - 16), n_classes - 1,
                                 replace=False))
        bounds = [0, *cuts, w]
        order = rs.permutation(n_classes)
        img = np.empty((h, w, 3), np.float32)
        for b in range(n_classes):
            band = slice(bounds[b], bounds[b + 1])
            masks[i, :, band] = order[b]
            img[:, band] = colors[order[b]]
        img += rs.randn(h, w, 3).astype(np.float32) * 10
        frames[i] = np.clip(img, 0, 255).astype(np.uint8)
    return frames, masks


class MemorySplit(DuckieSegDataset):
    """A split held in memory (frames and masks, no JPEG files): always
    the numpy rung of the loader."""
    from_jpeg_files = False

    def __init__(self, frames, masks, augmented, resolution,
                 backend="auto"):
        super().__init__("in-memory", augmented=augmented,
                         resolution=resolution, backend=backend)
        self.frames, self.masks = frames, masks

    def __len__(self):
        return len(self.frames)

    def _load_mask(self, idx):
        return self.masks[idx]

    def _load_raw(self, idx):
        return self.frames[idx], self.masks[idx]


class MemoryDINOSeg(DINOSeg):
    """DINOSeg whose train/val/test splits are in-memory arrays, handed to
    fit, evaluate and the dataloaders through _make_dataset."""

    def __init__(self, splits, **kw):
        super().__init__(data_path="in-memory", **kw)
        self.splits = splits

    def _make_dataset(self, path, augmented, resolution, backend="auto"):
        frames, masks = self.splits[path.rsplit("_", 1)[-1]]
        return MemorySplit(frames, masks, augmented, resolution, backend)


class FitLog:
    """What fit logs: per-epoch metrics and val confusion matrices."""

    def __init__(self):
        self.metrics, self.cms = [], []

    def log_metrics(self, metrics, step):
        self.metrics.append((step, dict(metrics)))

    def log_confusion_matrix(self, cm, title, step, labels=None,
                             file_name=None):
        self.cms.append(np.asarray(cm))


def fit_model(splits, write_path, **kw):
    base = dict(head="mlp", n_blocks=FIT_BLOCKS, n_classes=FIT_CLASSES,
                random_init=True, seed=5, optimizer="adam",
                max_epochs=FIT_EPOCHS, write_path=write_path,
                logger=FitLog(), device=FIT_DEVICE)
    base.update(kw)
    return MemoryDINOSeg(splits, **base)


def epoch_metrics(model):
    return [(s, m) for s, m in model.logger.metrics if s >= 0]


def pipeline_stats(model):
    """Per epoch, the host pipeline's numbers from fit's metrics: train
    frames/s with eval excluded, the step loop's wait on the loader, the
    mean step time and the share of the host's cores the process used."""
    cores = os.cpu_count() or 1
    return [{"epoch": s, "train_frames_per_s": m["train_frames_per_s"],
             "loader_wait_s": m["loader_wait_s"],
             "train_time_s": m["train_time_s"],
             "mean_step_s": m["train_time_s"] / m["train_steps"],
             "host_core_share": m["host_cpu_s"] / (m["train_time_s"] * cores),
             "train_loss": m["train_loss"], "val_acc": m["val_acc"]}
            for s, m in epoch_metrics(model)]


def launches_want(fwd=0, mlp=0, bwd=0, fwd_f32=0, bwd_f32=0):
    return {"flash_attn_fwd": fwd + fwd_f32, "flash_attn_fwd_f32": fwd_f32,
            "fused_ln_mlp": mlp, "flash_attn_bwd": bwd,
            "flash_attn_bwd_f32": bwd_f32, "flash_attn_fwd_dyn": 0,
            "flash_attn_bwd_dyn": 0}


def batches(n, batch):
    return -(-n // batch)


def same_weights(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return sa.keys() == sb.keys() and all(
        torch.equal(sa[k].cpu(), sb[k].cpu()) for k in sa)


def fit_unfrozen(splits, tmp, bare_fps):
    """(a) the unfrozen bf16 fit at the train bench's config."""
    model = fit_model(splits, os.path.join(tmp, "a"), precision="bf16",
                      freeze_backbone=False, batch_size=FIT_BATCH, lr=FIT_LR,
                      augmented=True, train_resolution=FIT_RES)
    train_ds = model._make_dataset(model.train_path, True, FIT_RES)
    route = loader_route(train_ds)
    # the loader alone over one epoch's samples: the host pipeline's rate
    # with no step to wait for
    t0 = time.perf_counter()
    n = sum(len(x) for x, _ in batched_loader(
        train_ds, np.arange(FIT_SAMPLES) % len(train_ds), FIT_BATCH,
        rng=np.random.default_rng(0)))
    loader_fps = n / (time.perf_counter() - t0)
    out, got = counted(lambda: model.fit(samples_per_epoch=FIT_SAMPLES,
                                         accum_steps=FIT_ACCUM))
    steps = FIT_EPOCHS * batches(FIT_SAMPLES, FIT_BATCH)
    evals = (FIT_EPOCHS * batches(FIT_FRAMES["val"], FIT_BATCH)
             + batches(FIT_FRAMES["test"], FIT_BATCH))
    per_step = 3 * FIT_ACCUM
    want = launches_want(fwd=per_step * steps + 3 * evals, mlp=3 * evals,
                         bwd=per_step * steps)
    stats = pipeline_stats(model)
    best = DINOSeg.load_from_checkpoint(model.best_ck, device=FIT_DEVICE)
    rec = {"phase": "fit", "part": "a unfrozen bf16", "res": FIT_RES,
           "blocks": FIT_BLOCKS, "batch": FIT_BATCH,
           "accum_steps": FIT_ACCUM, "samples_per_epoch": FIT_SAMPLES,
           "epochs": FIT_EPOCHS, "optimizer_steps": steps,
           "decode": "in-memory split", "loader_route": route,
           "augment_rung": ("native warp and blur"
                            if native_loader.get_lib() is not None
                            else "numpy"),
           "native_library_error": (native_loader.build_error or "")[:200],
           "launches": got, "want": want,
           "launches_per_step": {"flash_fwd_bf16_with_lse": per_step,
                                 "flash_bwd_bf16": per_step,
                                 "fused_mlp": 0},
           "launches_per_eval_batch": {"flash_fwd_bf16": 3, "fused_mlp": 3},
           "epochs_host": stats, "bare_step_frames_per_s": bare_fps,
           "loader_alone_frames_per_s": loader_fps, "host_cores":
               os.cpu_count(),
           "test": out, "best_checkpoint_reloads_equal":
               same_weights(best, model)}
    emit(rec)
    check(got == want, f"fit (a) launches {got}, want {want}")
    check(all(np.isfinite(e["train_loss"]) for e in stats),
          f"fit (a) non-finite loss {rec}")
    check(rec["best_checkpoint_reloads_equal"], "fit (a) best checkpoint")
    return got, {"epochs": stats, "loader_fps": loader_fps}


def fit_frozen_cached(splits, tmp):
    """(b) the frozen bf16 fit over the feature cache: the backbone runs in
    the precompute and the test pass only."""
    model = fit_model(splits, os.path.join(tmp, "b"), precision="bf16",
                      freeze_backbone=True, batch_size=FIT_BATCH, lr=1e-3,
                      augmented=False, train_resolution=FIT_RES)
    out, got = counted(lambda: model.fit(samples_per_epoch=FIT_SAMPLES,
                                         cache_features="auto"))
    evals = (batches(FIT_FRAMES["train"], FIT_BATCH)
             + batches(FIT_FRAMES["val"], FIT_BATCH)
             + batches(FIT_FRAMES["test"], FIT_BATCH))
    want = launches_want(fwd=3 * evals, mlp=3 * evals)
    tokens = (FIT_RES // 8) ** 2
    want_bytes = ((FIT_FRAMES["train"] + FIT_FRAMES["val"]) * tokens
                  * model.cfg.embed_dim * 2)
    cache = [m.get("feature_cache_bytes") for _, m in epoch_metrics(model)]
    rec = {"phase": "fit", "part": "b frozen bf16 feature cache",
           "res": FIT_RES, "feature_cache_bytes": cache[0],
           "feature_cache_bytes_want": want_bytes, "launches": got,
           "want": want, "flash_launches_in_epochs": got["flash_attn_fwd"]
           - want["flash_attn_fwd"], "epochs_host": pipeline_stats(model),
           "test": out}
    emit(rec)
    check(got == want, f"fit (b) launches {got}, want {want}")
    check(cache == [want_bytes] * FIT_EPOCHS, f"fit (b) cache bytes {rec}")
    return got


def cm_patches_moved(a, b):
    return int(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64)
                      ).sum() // 2)


def fit_parity(splits, tmp):
    """(c) the fp32 fit at 240px on the card against the same fit on the
    CPU, a resumed card fit against the uninterrupted one, and evaluate
    against fit's test metrics."""
    kw = dict(precision="fp32", freeze_backbone=False,
              batch_size=PARITY_BATCH, lr=PARITY_LR, augmented=True,
              train_resolution=PARITY_RES)
    fit_kw = dict(samples_per_epoch=PARITY_SAMPLES, resume=True)
    card = fit_model(splits, os.path.join(tmp, "c_card"), **kw)
    start = {k: v.detach().cpu().clone()
             for k, v in card.model.state_dict().items()}
    cpu = fit_model(splits, os.path.join(tmp, "c_cpu"), **dict(
        kw, device="cpu"))
    cpu.load_state_dict(start)
    out_card, got = counted(lambda: card.fit(**fit_kw))
    out_cpu = cpu.fit(**fit_kw)
    steps = FIT_EPOCHS * batches(PARITY_SAMPLES, PARITY_BATCH)
    evals = (FIT_EPOCHS * batches(FIT_FRAMES["val"], PARITY_BATCH)
             + batches(FIT_FRAMES["test"], PARITY_BATCH))
    want = launches_want(fwd_f32=3 * (steps + evals), bwd_f32=3 * steps)
    losses = [(a["train_loss"], b["train_loss"]) for (_, a), (_, b) in
              zip(epoch_metrics(card), epoch_metrics(cpu), strict=True)]
    moved = [cm_patches_moved(a, b) for a, b in
             zip(card.logger.cms, cpu.logger.cms, strict=True)]
    near = 0
    if any(moved):  # patches near a tie of the CPU's final weights
        ds = cpu._make_dataset(cpu.val_path, False, PARITY_RES)
        logp = cpu.forward(np.stack([ds.get(i)[0] for i in range(len(ds))]))
        near = int(near_ties(logp).sum())
    worst, worst_name, params_ok = 0.0, None, True
    card_params = dict(card.model.named_parameters())
    for name, p in cpu.model.named_parameters():
        d = (card_params[name].detach().cpu() - p.detach()).abs()
        lim = FIT_PARAM_TOL["atol"] + FIT_PARAM_TOL["rtol"] * p.detach().abs()
        params_ok &= bool((d <= lim).all())
        if d.max().item() >= worst:
            worst, worst_name = d.max().item(), name
    # resume: one epoch, then resume=True up to two, in another folder
    part = fit_model(splits, os.path.join(tmp, "c_part"), **dict(
        kw, max_epochs=1))
    part.load_state_dict(start)
    resumed = fit_model(splits, os.path.join(tmp, "c_part"), **kw)
    resumed.load_state_dict(start)
    _, got_part = counted(lambda: part.fit(**fit_kw))
    out_resumed, got_resumed = counted(lambda: resumed.fit(**fit_kw))
    with np.load(card.best_ck + ".resume.npz") as a, \
            np.load(resumed.best_ck + ".resume.npz") as b:
        resume_same = a.files == b.files and all(
            np.array_equal(a[k], b[k]) for k in a.files)
    evaluated, got_eval = counted(lambda: card.evaluate(card.test_path))
    rec = {"phase": "fit", "part": "c fp32 parity", "res": PARITY_RES,
           "batch": PARITY_BATCH, "samples_per_epoch": PARITY_SAMPLES,
           "lr": PARITY_LR, "train_loss_card_cpu": losses,
           "val_cm_patches_moved": moved, "val_near_tie_patches": near,
           "param_max_abs_diff": worst, "param_worst_leaf": worst_name,
           "params_within_tol": params_ok, "tol": {
               "loss_rtol": FIT_LOSS_RTOL, **FIT_PARAM_TOL},
           "test_card": out_card, "test_cpu": out_cpu,
           "resumed_equals_uninterrupted": resume_same
           and out_resumed == out_card and same_weights(resumed, card),
           "evaluate_equals_fit_test": evaluated == out_card,
           "launches": got, "want": want}
    emit(rec)
    check(got == want, f"fit (c) launches {got}, want {want}")
    check(all(abs(a - b) <= FIT_LOSS_RTOL * abs(b) for a, b in losses),
          f"fit (c) card loss disagrees with the CPU {rec}")
    check(max(moved) <= near, f"fit (c) confusion matrices {rec}")
    check(params_ok, f"fit (c) parameters disagree with the CPU {rec}")
    check(rec["resumed_equals_uninterrupted"], f"fit (c) resume {rec}")
    check(rec["evaluate_equals_fit_test"], f"fit (c) evaluate {rec}")
    total = {}
    for c in (got, got_part, got_resumed, got_eval):
        add_counts(total, c)
    return total


def augment_batch_params(seed, n=FIT_BATCH, size=FIT_RES):
    """n samples' parameters drawn from ``seed``, with the first seven set
    so that every op fires at least once: a crop, an affine with a crop, a
    flip, two jitters in different orders, the widest blur, the
    identity."""
    params = [draw_params(np.random.default_rng([seed, i]), size)
              for i in range(n)]
    null = {"crop": None, "affine": None, "flip": False, "jitter": None,
            "blur": None}
    rng = np.random.default_rng(seed)
    factors = (1.3, 0.85, 1.15, 0.12)
    params[:7] = [
        dict(null, crop=(31, 17, 301, 288)),
        dict(null, crop=(5, 40, 420, 410), affine=params[1]["affine"]
             if params[1]["affine"] is not None
             else np.array([[0.95, 0.26, 12.0], [-0.26, 0.95, -30.0]])),
        dict(null, flip=True),
        dict(null, jitter=(np.array([0, 1, 2, 3]), factors)),
        dict(null, jitter=(np.array([3, 2, 1, 0]), factors), flip=True),
        dict(null, blur=MAX_BLUR, crop=(0, 0, size, size)),
        dict(null)]
    params[7] = dict(params[7], jitter=(rng.permutation(4), factors))
    return params


def profile_kernels(fn):
    """(device kernels, device copies, device busy ms) of one call of
    ``fn`` as torch.profiler sees them."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = copies = 0
    busy_us = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "memcpy" in e.key.lower() or "memset" in e.key.lower():
            copies += e.count
        else:
            kernels += e.count
        busy_us += e.self_device_time_total
    return kernels, copies, busy_us / 1e3


def fit_augment_on_card(splits):
    """(d) device_augment_batch on the card against the port's CPU run of
    the same staged batch at the fit config, twice; its device ms per batch
    (CUDA events, median of bursts), host ms per call and the device
    kernels per batch."""
    frames, _ = splits["train"]
    params = augment_batch_params(7)
    imgs = np.stack([resize_pair(frames[i % len(frames)], None, FIT_RES)[0]
                     for i in range(FIT_BATCH)])
    staged, packed = prepare_device_batch(imgs, params, FIT_RES)
    want = device_augment_batch(staged, packed, device="cpu")
    card = torch.device("cuda")
    got, launched = counted(lambda: [
        device_augment_batch(staged, packed, device=card).cpu()
        for _ in range(2)])
    diffs = [int((g.to(torch.int16) - want.to(torch.int16)).abs().max())
             for g in got]
    dev_imgs = torch.from_numpy(staged).to(card)

    def call():
        return device_augment_batch(dev_imgs, packed, device=card)

    device_ms = median_ms(call)
    host = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    kernels, copies, busy_ms = profile_kernels(call)
    rec = {"phase": "fit", "part": "d device augmentation", "res": FIT_RES,
           "batch": FIT_BATCH,
           "ops_fired": {"crop": int((packed[:, 0] > 0.5).sum()),
                         "affine_staged_on_host": sum(
                             p["affine"] is not None for p in params),
                         "flip": int((packed[:, 12] > 0.5).sum()),
                         "jitter": int((packed[:, 13] > 0.5).sum()),
                         "jitter_orders": len({tuple(r) for r in
                                               packed[packed[:, 13] > 0.5,
                                                      14:18]}),
                         "blur": int((packed[:, 22] > 0.5).sum())},
           "card_vs_cpu_max_abs_diff": diffs,
           "same_bits_as_cpu": [bool(torch.equal(g, want)) for g in got],
           "launches_of_the_six_kernels": launched,
           "device_ms_per_batch": device_ms,
           "host_ms_per_call_median": float(np.median(host)),
           "host_ms_per_call_min": float(np.min(host)),
           "device_kernels_per_batch": kernels,
           "device_copies_per_batch": copies,
           "profiled_busy_ms_per_batch": busy_ms}
    emit(rec)
    check(rec["same_bits_as_cpu"] == [True, True],
          f"fit (d) card augmentation differs from the CPU's {rec}")
    check(all(v == 0 for v in launched.values()),
          f"fit (d) the augmentation launched a kernel {launched}")
    check(rec["ops_fired"]["jitter_orders"] >= 2 and all(
        v > 0 for v in rec["ops_fired"].values()), f"fit (d) ops {rec}")
    return rec


def fit_unfrozen_device(splits, tmp, bare_fps, host_a, augment):
    """(e) the unfrozen bf16 fit of (a) with augment_backend='device', and
    the loader alone with the device augmentation over one epoch's
    samples."""
    model = fit_model(splits, os.path.join(tmp, "e"), precision="bf16",
                      freeze_backbone=False, batch_size=FIT_BATCH, lr=FIT_LR,
                      augmented=True, train_resolution=FIT_RES)
    train_ds = model._make_dataset(model.train_path, True, FIT_RES, "device")
    route = loader_route(train_ds)
    calls0 = device_augment_batch.calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for x, _ in batched_loader(train_ds, np.arange(FIT_SAMPLES)
                               % len(train_ds), FIT_BATCH,
                               rng=np.random.default_rng(0),
                               device=model.device):
        check(x.is_cuda, "fit (e) the loader's frames are not on the card")
        n += len(x)
    torch.cuda.synchronize()
    loader_fps = n / (time.perf_counter() - t0)
    calls1 = device_augment_batch.calls
    out, got = counted(lambda: model.fit(samples_per_epoch=FIT_SAMPLES,
                                         accum_steps=FIT_ACCUM,
                                         augment_backend="device"))
    steps = FIT_EPOCHS * batches(FIT_SAMPLES, FIT_BATCH)
    evals = (FIT_EPOCHS * batches(FIT_FRAMES["val"], FIT_BATCH)
             + batches(FIT_FRAMES["test"], FIT_BATCH))
    per_step = 3 * FIT_ACCUM
    want = launches_want(fwd=per_step * steps + 3 * evals, mlp=3 * evals,
                         bwd=per_step * steps)
    stats = pipeline_stats(model)
    best = DINOSeg.load_from_checkpoint(model.best_ck, device=FIT_DEVICE)
    rec = {"phase": "fit", "part": "e unfrozen bf16, device augmentation",
           "res": FIT_RES, "blocks": FIT_BLOCKS, "batch": FIT_BATCH,
           "accum_steps": FIT_ACCUM, "samples_per_epoch": FIT_SAMPLES,
           "epochs": FIT_EPOCHS, "optimizer_steps": steps,
           "loader_route": route, "launches": got, "want": want,
           "device_augment_calls_loader_alone": calls1 - calls0,
           "device_augment_calls_in_fit": device_augment_batch.calls - calls1,
           "epochs_host": stats,
           "loader_alone_frames_per_s": loader_fps,
           "beside": {"a_epochs_frames_per_s": [
                          e["train_frames_per_s"] for e in host_a["epochs"]],
                      "a_loader_alone_frames_per_s": host_a["loader_fps"],
                      "bare_step_frames_per_s": bare_fps,
                      "d_device_ms_per_batch": augment[
                          "device_ms_per_batch"],
                      "d_host_ms_per_call": augment[
                          "host_ms_per_call_median"]},
           "host_cores": os.cpu_count(), "test": out,
           "best_checkpoint_reloads_equal": same_weights(best, model)}
    emit(rec)
    check(route == "device augment", f"fit (e) route {route}")
    check(got == want, f"fit (e) launches {got}, want {want}")
    check(rec["device_augment_calls_in_fit"] == steps,
          f"fit (e) device augmentation calls {rec}")
    check(rec["device_augment_calls_loader_alone"]
          == batches(FIT_SAMPLES, FIT_BATCH), f"fit (e) loader calls {rec}")
    check(all(np.isfinite(e["train_loss"]) for e in stats),
          f"fit (e) non-finite loss {rec}")
    check(rec["best_checkpoint_reloads_equal"], "fit (e) best checkpoint")
    return got


def phase_fit(bare_fps):
    """Phase 9 (fit): (a) the unfrozen bf16 fit at the bench config, (b) the
    frozen bf16 fit over the feature cache, (c) the fp32 parity fit, (d) the
    device augmentation on the card against the CPU, (e) (a)'s fit with
    augment_backend='device'; returns the phase's launch counts (every
    count zeroed before each card run and read after it)."""
    splits = {name: memory_split(n, seed) for seed, (name, n) in
              enumerate(FIT_FRAMES.items())}
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        got, host_a = fit_unfrozen(splits, tmp, bare_fps)
        FIT_A_FPS[:] = [e["train_frames_per_s"] for e in host_a["epochs"]]
        add_counts(total, got)
        add_counts(total, fit_frozen_cached(splits, tmp))
        add_counts(total, fit_parity(splits, tmp))
        augment = fit_augment_on_card(splits)
        add_counts(total, fit_unfrozen_device(splits, tmp, bare_fps, host_a,
                                              augment))
    emit({"phase": "fit", "launches": total})
    return total


# ---------------------------------------------------------------------------
# Phase 10: serving and export (fixed-shape predict programs, the server)
# ---------------------------------------------------------------------------

SERVE_RES, SERVE_BATCH, SERVE_HW = 480, 3, (480, 640)
SERVE_F32_RES = 240
# load readings: 12 client threads post 512 requests (300 distinct JPEGs,
# then the first 212 again), so /stats's latency window (the last 512
# requests) holds exactly one reading
SERVE_CLIENTS, SERVE_JPEGS, SERVE_POSTS = 12, 300, 512
SERVE_WARMUP_POSTS = 36
SERVE_READINGS = ((3, 0), (1, 0), (1, 1), (3, 1))  # (max_batch, reading)
# timeout of the batching window where the requests must coalesce into
# known rounds (the bucket checks of (b)); the load servers keep the
# server's default 3 ms
SERVE_COALESCE_MS = 500.0
# the profiler's names of the kernels a replay must launch
REPLAY_KERNELS = ("flash_fwd_bf16", "flash_fwd_f32", "fused_ln_mlp_kernel")


def replay_kernel_counts(fn, n=2):
    """Launches per call of each of REPLAY_KERNELS (and of every kernel
    whose name holds ``flash``) seen by torch.profiler over n calls of
    ``fn``: the kernels of a CUDA-graph replay, which the wrappers' counters
    do not see."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(REPLAY_KERNELS, 0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in counts:
            if name in e.key:
                counts[name] += e.count
        if "flash" in e.key and not any(k in e.key for k in REPLAY_KERNELS):
            counts[e.key[:60]] = counts.get(e.key[:60], 0) + e.count
    return {k: v / n for k, v in counts.items()}


def serve_jpegs(n, seed, quality=90):
    """n distinct 480x640 colour-band frames (memory_split's recipe),
    encoded as JPEG bodies by Pillow."""
    from PIL import Image
    frames, _ = memory_split(n, seed)
    out = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(f).save(buf, format="JPEG", quality=quality)
        out.append(buf.getvalue())
    return frames, out


def png_body(img):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def http(port, route, body=None, headers=None):
    """(body, content type) of a GET (no body) or POST to the local
    server."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}",
                                 data=body, headers=headers or {},
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.read(), resp.headers.get("Content-Type")


def http_json(port, route):
    return json.loads(http(port, route)[0])


def post_many(port, bodies, clients, route="/predict"):
    """POST every body from ``clients`` threads (thread i takes bodies i,
    i + clients, ...); returns the responses in order."""
    out = [None] * len(bodies)

    def worker(i):
        for j in range(i, len(bodies), clients):
            out[j] = http(port, route, bodies[j])[0]

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(min(clients, len(bodies)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        check(not t.is_alive(), "a client thread hung")
    check(all(r is not None for r in out), "a request got no answer")
    return out


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_server(path, **kw):
    port = free_port()
    server = make_server(path, port=port, **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, port


def stop_server(server):
    server.shutdown()
    server.server_close()


def rounds_delta(before, after):
    a, b = after["batch_rounds"], before["batch_rounds"]
    return {k: v - b.get(k, 0) for k, v in a.items() if v - b.get(k, 0)}


def serve_exported(model, frames3, tmp):
    """(a) the bench config's artifact (bf16, batch 3, 480x640 at 480px)
    and an fp32 one at 240px, batch 1, each loaded (captured) and held to
    eager predict_batch bit for bit; each replay's kernels by the
    profiler.  Returns the launch counts of the phase's calls."""
    total = {}
    for prec, res, frames in (("bf16", SERVE_RES, frames3),
                              ("fp32", SERVE_F32_RES, frames3[:1])):
        model.set_resolution(res)
        path = os.path.join(tmp, f"{prec}_{res}.dtts")
        t0 = time.perf_counter()
        export_predict(model, path, batch_size=len(frames),
                       in_shape=SERVE_HW, precision=prec)
        t_export = time.perf_counter() - t0
        served, load_counts = counted(
            lambda: load_exported_predict(path))
        t_load = time.perf_counter() - t0 - t_export
        got, call_counts = counted(lambda: (served(frames), served(frames)))
        want, eager_counts = counted(
            lambda: model.predict_batch(frames, precision=prec))
        per_replay = replay_kernel_counts(lambda: served(frames))
        for c in (load_counts, call_counts, eager_counts):
            add_counts(total, c)
        mlp = 3 if prec == "bf16" else 0
        fwd = "flash_fwd_bf16" if prec == "bf16" else "flash_fwd_f32"
        rec = {"phase": "serve", "part": "a", "precision": prec, "res": res,
               "contract": served.contract, "export_s": t_export,
               "load_and_capture_s": t_load,
               "same_bits_as_predict_batch": bool(
                   (got[0] == want).all() and (got[1] == want).all()),
               "labels_differing": int((got[0] != want).sum()),
               "replays_same_bits": bool((got[0] == got[1]).all()),
               "kernels_per_replay": per_replay,
               "launches_counted_at_load": load_counts,
               "launches_counted_in_replays": call_counts,
               "artifact_bytes": os.path.getsize(path)}
        emit(rec)
        check(served.contract["output"]["shape"] == [len(frames), 480, 480],
              f"serve (a) contract {rec}")
        check(rec["same_bits_as_predict_batch"] and rec["replays_same_bits"],
              f"serve (a) {prec} labels differ from predict_batch: {rec}")
        check(per_replay[fwd] == 3 and per_replay["fused_ln_mlp_kernel"]
              == mlp and sum(per_replay.values()) == 3 + mlp,
              f"serve (a) {prec} replay kernels {per_replay}")
        # a replay goes past the wrappers: their counters stay where the
        # warm-up and the capture left them
        check(call_counts["flash_attn_fwd"] == 0,
              f"serve (a) replays counted by the wrappers {call_counts}")
        check(load_counts["flash_attn_fwd"] == 6
              and load_counts["fused_ln_mlp"] == 2 * mlp,
              f"serve (a) warm-up and capture launches {load_counts}")
    model.set_resolution(SERVE_RES)
    return total


def serve_requests(model, frames3, tmp):
    """(b) the server over the bench config's checkpoint, --max_batch 3:
    the requests of tests/test_serve.py, and rounds of 1, 2 and 3 frames
    held to predict_batch of the same padded bucket, bit for bit.  Returns
    (checkpoint path, launch counts)."""
    ckpt = os.path.join(tmp, "bench.ckpt.npz")
    model.save(ckpt)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    server, port = start_server(ckpt, resolution=SERVE_RES, precision="bf16",
                                max_batch=SERVE_BATCH,
                                batch_timeout_ms=SERVE_COALESCE_MS)
    try:
        health = http_json(port, "/healthz")
        check(health["backend"] == "model" and health["device"] == "cuda"
              and health["max_batch"] == SERVE_BATCH, f"healthz {health}")
        img = frames3[0]
        want = model.predict_batch(img[None], precision="bf16")[0]
        stats0 = http_json(port, "/stats")
        body32, ctype = http(port, "/predict", png_body(img))
        lab32 = np.load(io.BytesIO(body32))
        formats = {"int32": ctype == "application/octet-stream"
                   and lab32.dtype == np.int32
                   and bool((lab32 == want).all())}
        body8, ctype = http(port, "/predict?format=npy8", png_body(img))
        formats["npy8"] = (ctype == "application/x-npy-uint8"
                           and bool((np.load(io.BytesIO(body8)) == want).all())
                           and len(body8) < len(body32) / 3.9)
        body, ctype = http(port, "/predict", png_body(img),
                           {"Accept": "application/x-npy-uint8"})
        formats["accept_npy8"] = (ctype == "application/x-npy-uint8" and bool(
            (np.load(io.BytesIO(body)) == want).all()))
        from PIL import Image
        body, ctype = http(port, "/predict?format=pngl", png_body(img))
        formats["pngl"] = (ctype == "image/png" and bool(
            (np.asarray(Image.open(io.BytesIO(body))) == want).all()))
        body, ctype = http(port, "/predict?format=png", png_body(img))
        formats["png"] = (ctype == "image/png" and Image.open(
            io.BytesIO(body)).size == (480, 480))
        # a JPEG body against its own decode: the native rung where it
        # built, else Pillow
        _, (jpeg,) = serve_jpegs(1, seed=41)
        decoded = native_loader.decode_bytes(jpeg)
        rung = "native"
        if decoded is None:
            decoded, rung = np.asarray(
                Image.open(io.BytesIO(jpeg)).convert("RGB")), "pillow"
        lab = np.load(io.BytesIO(http(port, "/predict", jpeg)[0]))
        formats["jpeg"] = bool((lab == model.predict_batch(
            decoded[None], precision="bf16")[0]).all())
        # rounds of 2 and 3 distinct frames run the bucket-2 and bucket-3
        # programs; each frame's map is its row of predict_batch on them
        buckets = {}
        for n in (2, 3):
            before = http_json(port, "/stats")
            got = post_many(port, [png_body(f) for f in frames3[:n]], n)
            rounds = rounds_delta(before, http_json(port, "/stats"))
            want_n = model.predict_batch(frames3[:n], precision="bf16")
            buckets[n] = {"rounds": rounds, "same_bits": all(
                bool((np.load(io.BytesIO(g)) == w).all())
                for g, w in zip(got, want_n))}
        torch.cuda.synchronize()
        stats = http_json(port, "/stats")
        rec = {"phase": "serve", "part": "b", "max_batch": SERVE_BATCH,
               "decode_rung": rung, "native_decode": health["native_decode"],
               "native_build_error": native_loader.build_error,
               "cold_start": health["cold_start"], "formats": formats,
               "buckets": buckets, "stats": stats,
               "first_rounds": rounds_delta(stats0, stats),
               "programs_peak_bytes": torch.cuda.max_memory_allocated() - base,
               "programs_held_bytes": torch.cuda.memory_allocated() - base,
               "launches": all_counts()}
        emit(rec)
        check(all(formats.values()), f"serve (b) formats {rec}")
        for n, b in buckets.items():
            check(b["rounds"] == {str(n): 1} and b["same_bits"],
                  f"serve (b) bucket {n}: {rec}")
        check(stats["errors"] == 0, f"serve (b) errors {stats}")
        return ckpt, rec["launches"]
    finally:
        stop_server(server)


def load_reading(port, bodies):
    """One load reading: SERVE_POSTS requests from SERVE_CLIENTS threads
    (``?format=npy8``); frames/s, /stats p50/p95 (its window holds exactly
    this reading), the rounds of the reading and the process's share of
    the host's cores."""
    posts = [bodies[i % len(bodies)] for i in range(SERVE_POSTS)]
    before = http_json(port, "/stats")
    cpu0, t0 = time.process_time(), time.perf_counter()
    out = post_many(port, posts, SERVE_CLIENTS, "/predict?format=npy8")
    wall, cpu = time.perf_counter() - t0, time.process_time() - cpu0
    after = http_json(port, "/stats")
    labels = np.load(io.BytesIO(out[-1]))
    check(labels.shape == (480, 480) and labels.dtype == np.uint8
          and int(labels.max()) < 7, "serve (c) labels")
    check(after["latency_ms"]["window"] == SERVE_POSTS
          and after["errors"] == before["errors"], f"serve (c) {after}")
    return {"frames_per_s": SERVE_POSTS / wall, "wall_s": wall,
            "p50_ms": after["latency_ms"]["p50"],
            "p95_ms": after["latency_ms"]["p95"],
            "batch_rounds": rounds_delta(before, after),
            "host_core_share": cpu / (wall * os.cpu_count())}


def serve_load(ckpt):
    """(c) load: a server per --max_batch (3, then 1) at the bench config,
    each warmed by SERVE_WARMUP_POSTS requests, then readings in turns.
    Timing runs: their launches are not counted."""
    frames, bodies = serve_jpegs(SERVE_JPEGS, seed=40)
    servers = {}
    try:
        for mb in (3, 1):
            servers[mb] = start_server(ckpt, resolution=SERVE_RES,
                                       precision="bf16", max_batch=mb)
            post_many(servers[mb][1], bodies[:SERVE_WARMUP_POSTS],
                      SERVE_CLIENTS)
        readings = {3: [], 1: []}
        for mb, _ in SERVE_READINGS:
            readings[mb].append(load_reading(servers[mb][1], bodies))
        emit({"phase": "serve", "part": "c", "clients": SERVE_CLIENTS,
              "distinct_jpegs": SERVE_JPEGS, "posts": SERVE_POSTS,
              "format": "npy8", "order": [mb for mb, _ in SERVE_READINGS],
              "host_cores": os.cpu_count(),
              "max_batch_3": readings[3], "max_batch_1": readings[1]})
    finally:
        for server, _ in servers.values():
            stop_server(server)


def serve_in_process(model, frames3):
    """(d) predict_batch's eager forward against the program's replay at
    the bench config, each call from host frames to host labels: host ms
    per batch (median of bursts) in turns (eager, graph, graph, eager),
    then the profiler's device busy ms and idle share of each.  Timing
    runs: their launches are not counted."""
    model.set_resolution(SERVE_RES)
    program = predict_program(model, SERVE_BATCH, SERVE_HW, "bf16")
    calls = {"eager": lambda: model.predict_batch(frames3, precision="bf16"),
             "graph": lambda: program(frames3)}
    check((calls["graph"]() == calls["eager"]()).all(),
          "serve (d) program != predict_batch")

    def host_ms(fn, rounds=5, burst=10):
        fn()
        times = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(burst):
                fn()
            times.append((time.perf_counter() - t0) / burst * 1e3)
        return float(np.median(times))

    ms = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        ms[name].append(host_ms(calls[name]))
    rec = {"phase": "serve", "part": "d", "batch": SERVE_BATCH,
           "res": SERVE_RES, "precision": "bf16", "order":
           ["eager", "graph", "graph", "eager"]}
    for name, fn in calls.items():
        bd = bench.device_breakdown(fn, 10, float(np.median(ms[name])))
        rec[name] = {"host_ms": ms[name], "device_busy_ms":
                     bd["device_busy_ms"], "device_idle_share":
                     bd["device_idle_share"], "top_kernels": bd["kernels"][:4]}
    emit(rec)


def phase_serve(model, frames3):
    """Phase 10 (serve): (a) export and load at the bench config, (b) the
    server's requests, (c) load at --max_batch 3 and 1, (d) eager against
    the program in process; returns the phase's launch counts."""
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        add_counts(total, serve_exported(model, frames3, tmp))
        ckpt, launches = serve_requests(model, frames3, tmp)
        add_counts(total, launches)
        serve_load(ckpt)
    serve_in_process(model, frames3)
    emit({"phase": "serve", "launches": total})
    for name in ("flash_attn_fwd", "flash_attn_fwd_f32", "fused_ln_mlp"):
        check(total[name] > 0, f"{name} never launched by serve")
    return total


# ---------------------------------------------------------------------------
# Phase 11: int8 serving, the MoE head, the cnn1/cnn2 backbones
# ---------------------------------------------------------------------------

# int8 labels, card vs the port's CPU int8 run: both run bf16 around the
# int8 products (the flash kernel against the plain attention, cuBLAS
# against CPU sums), so a bf16 step may flip an argmax whose top-2 gap is
# below INT8_MARGIN (tests/test_torch_port_quant.py measured 2.9e-3 of
# log-prob spread against dino_tpu)
INT8_MARGIN = 1e-2
# cnn labels, card vs CPU: fp32 and bf16 top-2 gaps below which argmax may
# flip.  The random-init ResNet's eval BatchNorm (mean 0, var 1) leaves
# activations of ~1e3, so a bf16 step of a conv's sum is ~4 and the two
# devices' sum orders part the log-probs by up to 0.34 (cnn1) and 0.67
# (cnn2) in bf16, 6.5e-5 and 1.7e-4 in fp32, on this script's seeds
CNN_MARGIN = {"fp32": 1e-3, "bf16": 1.0}
# cnn features, card fp32 vs CPU fp32: max |err| against max |ref|
CNN_F32_REL = 1e-4
# the cnn step's running stats, card vs CPU, per channel: a running var
# against itself, a running mean against max(|mean|, sqrt(var)), the
# channel's spread (where train-mode BatchNorm feeds a linear layer into
# the next, as in the last bottleneck, that channel's batch mean is 0 up
# to rounding)
CNN_STATS_REL = 1e-5
# a gradient leaf whose exact value vanishes (train-mode BatchNorm cancels
# a per-channel shift of its input: the last bottleneck's bn2.bias) holds
# only rounding noise; each leaf is held against max(its own max |g|, this
# share of the model's largest |g|)
CNN_GRAD_FLOOR = 1e-3
MOE_EXPERTS, MOE_AMPLE = 4, 4.0  # capacity factor >= E: nothing drops
INT8_MM_SHAPE = (10803, 384, 1536)  # fc1 of a 480px batch of 3


def host_and_device_ms(calls, order):
    """Host ms per call (median of 5 bursts of 10) for each named call, in
    ``order`` (turns), then the profiler's device busy ms and idle share of
    one call of each."""
    def host_ms(fn, rounds=5, burst=10):
        fn()
        times = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(burst):
                fn()
            times.append((time.perf_counter() - t0) / burst * 1e3)
        return float(np.median(times))

    ms = {name: [] for name in calls}
    for name in order:
        ms[name].append(host_ms(calls[name]))
    out = {}
    for name, fn in calls.items():
        bd = bench.device_breakdown(fn, 10, float(np.median(ms[name])))
        out[name] = {"host_ms": ms[name],
                     "device_busy_ms": bd["device_busy_ms"],
                     "device_idle_share": bd["device_idle_share"],
                     "top_kernels": bd["kernels"][:5]}
    return out


def cpu_twin(model, **kw):
    """The port's CPU run of ``model``: the same configuration and weights
    (``kw`` overrides), on the CPU."""
    hp = {k: model.hparams[k] for k in ("head", "n_blocks", "n_classes",
                                        "backbone", "precision", "n_experts",
                                        "moe_dispatch", "moe_capacity",
                                        "freeze_backbone")}
    hp.update(kw)
    cpu = DINOSeg(random_init=True, device="cpu", **hp)
    cpu.load_state_dict({k: v.cpu() for k, v in
                         model.model.state_dict().items()})
    return cpu


def int8_codes_match(model, cpu):
    """Every quantized layer's codes and scales, card vs CPU: (layers,
    layers differing)."""
    card_q = dict(model._serving_model("int8").dino.named_buffers())
    cpu_q = dict(cpu._serving_model("int8").dino.named_buffers())
    names = [k for k in card_q if k.endswith(("weight_i8", "w_scale"))]
    differ = [k for k in names if not torch.equal(card_q[k].cpu(), cpu_q[k])]
    return len(names), differ


def phase_int8(model, frames3, tmp):
    """(a) int8 at the bench config: codes, labels against the CPU, the
    program against eager, launches, timings.  Returns the launch
    counts."""
    model.set_resolution(480)
    cpu = cpu_twin(model, precision="int8")
    n_layers, differ = int8_codes_match(model, cpu)
    got, counts = counted(lambda: model.predict_batch(frames3,
                                                      precision="int8"))
    total = dict(counts)
    want = cpu.predict_batch(frames3)
    logp = cpu.log_probs(torch.from_numpy(frames3))
    n_diff, n_far = labels_agree(got, want, near_ties(logp, INT8_MARGIN), 60)
    bf16 = model.predict_batch(frames3, precision="bf16")
    path = os.path.join(tmp, "int8_480.dtts")
    export_predict(model, path, batch_size=3, in_shape=SERVE_HW,
                   precision="int8")
    served, load_counts = counted(lambda: load_exported_predict(path))
    add_counts(total, load_counts)
    replays = (served(frames3), served(frames3))
    eager, eager_counts = counted(lambda: model.predict_batch(
        frames3, precision="int8"))
    add_counts(total, eager_counts)
    per_replay = replay_kernel_counts(lambda: served(frames3))
    rec = {"phase": "item8", "part": "a", "what": "int8", "res": 480,
           "batch": 3, "quantized_tensors": n_layers,
           "codes_or_scales_differing_card_vs_cpu": differ,
           "launches_per_batch": counts,
           "patches_differing_vs_cpu": n_diff,
           "of_them_away_from_near_ties": n_far,
           "near_tie_margin": INT8_MARGIN,
           "near_tie_patches": int(near_ties(logp, INT8_MARGIN).sum()),
           "agreement_with_bf16_card": float((got == bf16).mean()),
           "program_same_bits_as_eager": bool(
               (replays[0] == eager).all() and (replays[1] == eager).all()),
           "kernels_per_replay": per_replay,
           "launches_counted_at_load": load_counts,
           "artifact_bytes": os.path.getsize(path)}
    emit(rec)
    check(not differ, f"int8 codes differ card vs CPU {rec}")
    check(n_far == 0, f"int8 labels differ from the CPU's {rec}")
    check(rec["program_same_bits_as_eager"], f"int8 program != eager {rec}")
    check(counts["flash_attn_fwd"] == 3 and counts["fused_ln_mlp"] == 0
          and counts["flash_attn_fwd_f32"] == 0, f"int8 launches {rec}")
    check(per_replay["flash_fwd_bf16"] == 3
          and per_replay["fused_ln_mlp_kernel"] == 0,
          f"int8 replay kernels {per_replay}")

    # int8 and bf16 predict_batch in turns, eager and through the program
    programs = {prec: predict_program(model, 3, SERVE_HW, prec)
                for prec in ("int8", "bf16")}
    calls = {"int8_eager": lambda: model.predict_batch(frames3,
                                                       precision="int8"),
             "bf16_eager": lambda: model.predict_batch(frames3,
                                                       precision="bf16"),
             "int8_program": lambda: programs["int8"](frames3),
             "bf16_program": lambda: programs["bf16"](frames3)}
    order = ["bf16_eager", "int8_eager", "int8_eager", "bf16_eager",
             "bf16_program", "int8_program", "int8_program", "bf16_program"]
    timing = host_and_device_ms(calls, order)
    m, k, n = INT8_MM_SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    a8 = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                       dtype=torch.int8)
    b8 = torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                       dtype=torch.int8)
    a16, b16 = a8.to(torch.bfloat16), b8.to(torch.bfloat16)
    mm = {"int_mm_ms": kernel_times(lambda: torch._int_mm(a8, b8.t())),
          "bf16_mm_ms": kernel_times(lambda: torch.mm(
              a16, b16.t(), out_dtype=torch.float32))}
    int8_bound = max(2 * m * k * n / 1979e12,
                     (m * k + n * k + 4 * m * n) / HBM_BYTES_PER_S) * 1e3
    bf16_bound = bound_ms(2 * m * k * n, 2 * (m * k + n * k) + 4 * m * n,
                          torch.bfloat16)[0]
    emit({"phase": "item8", "part": "a", "what": "int8 timing",
          "order": order, "timing": timing, "mm_shape": [m, k, n],
          "mm": mm, "int_mm_bound_ms": int8_bound,
          "bf16_mm_bound_ms": bf16_bound})
    return total


def phase_moe(model, frames3):
    """(b) the MoE head (4 experts) on the bench ViT: dense vs sparse bf16
    predict at 480px; the unfrozen bf16 train step at the train bench
    config (2 steps, exact launches); the fp32 step at 240px against the
    CPU; one SP step in a world of one over NCCL.  Returns the launch
    counts."""
    total = {}
    dense = DINOSeg(head="moe", n_experts=MOE_EXPERTS, n_blocks=3,
                    n_classes=7, precision="bf16", random_init=True, seed=0)
    dense.model.dino.load_state_dict(model.model.dino.state_dict())
    sparse = DINOSeg(head="moe", n_experts=MOE_EXPERTS, n_blocks=3,
                     n_classes=7, precision="bf16", random_init=True, seed=0,
                     moe_dispatch="sparse", moe_capacity=MOE_AMPLE)
    sparse.load_state_dict(dense.model.state_dict())
    a, counts = counted(lambda: dense.predict_batch(frames3))
    add_counts(total, counts)
    b, counts_s = counted(lambda: sparse.predict_batch(frames3))
    add_counts(total, counts_s)
    rec = {"phase": "item8", "part": "b", "what": "moe predict", "res": 480,
           "batch": 3, "experts": MOE_EXPERTS, "capacity_factor": MOE_AMPLE,
           "sparse_same_labels_as_dense": bool((a == b).all()),
           "labels_differing": int((a != b).sum()),
           "launches_dense": counts, "launches_sparse": counts_s}
    emit(rec)
    check(rec["sparse_same_labels_as_dense"], f"MoE sparse != dense {rec}")
    check(counts["flash_attn_fwd"] == 3 and counts["fused_ln_mlp"] == 3,
          f"MoE predict launches {rec}")

    # the unfrozen bf16 step at the train bench's shapes: per step the
    # stats pass's 8 forwards (flash forward and fused MLP, no gradient)
    # and the gradient pass's 8 (flash forward with LSE, flash backward)
    zero_counts()
    train = DINOSeg(head="moe", n_experts=MOE_EXPERTS, n_blocks=3,
                    n_classes=7, precision="bf16", random_init=True, seed=1,
                    freeze_backbone=False)
    _, times = train_run(train, False, "bf16", 480, 16, 8, 2,
                         (48, 24, 24, 0), seed=2)
    add_counts(total, all_counts())
    emit({"phase": "item8", "part": "b", "what": "moe train bf16",
          "step_host_s": times, "launches_per_step": {
              "flash_attn_fwd": 48, "of_them_stats_pass": 24,
              "fused_ln_mlp": 24, "flash_attn_bwd": 24}})
    # the fp32 step at 240px, repeated on the CPU
    zero_counts()
    cpu = cpu_twin(train, precision="fp32")
    loss, _ = train_run(train, False, "fp32", 240, 2, 1, 1, (3, 0, 0, 3),
                        seed=4)
    add_counts(total, all_counts())
    phase_train_cpu_reference(train, cpu, loss.item(), seed=4, phase="moe")
    # SP: one fp32 step in a world of one over NCCL against the
    # single-device step
    store = tempfile.mkdtemp(prefix="dtt_moe_sp_")
    pdist.init_distributed_mode("nccl", f"file://{store}/store", 1, 0)
    try:
        rs = np.random.RandomState(8)
        imgs = torch.from_numpy(rs.randint(0, 255, (2, 240, 240, 3)).astype(
            np.uint8)).cuda()
        labels = torch.from_numpy(rs.randint(0, 7, (2, 900)).astype(
            np.int32)).cuda()

        def moe_step(make):
            m = DINOSeg(head="moe", n_experts=MOE_EXPERTS, n_blocks=3,
                        n_classes=7, precision="fp32", random_init=True,
                        seed=5, freeze_backbone=False)
            opt = make_optimizer("adam", 1e-5)
            st = init_opt_state(opt, m.model.dino, m.model.clf, False)
            loss, cm = make(m.cfg, opt)(m.model.dino, m.model.clf, st, imgs,
                                        labels)
            return m, loss
        ref_m, ref_loss = moe_step(lambda cfg, opt: make_train_step(
            cfg, "moe", 7, opt, False))
        (sp_m, sp_loss), got = counted(lambda: moe_step(
            lambda cfg, opt: make_sp_train_step(cfg, "moe", 7, opt)))
        add_counts(total, got)
        worst, leaf, ok = _grad_report(sp_m.model.named_parameters(),
                                       ref_m.model.named_parameters(),
                                       STEP_GRAD_REL)
        rec = {"phase": "item8", "part": "b", "what": "moe sp world 1",
               "backend": "nccl", "res": 240, "loss": sp_loss.item(),
               "loss_single_device": ref_loss.item(), "launches": got,
               "grad_worst_rel_diff": worst, "grad_worst_leaf": leaf}
        emit(rec)
        check(got == sp_want(3, bwd_f32=3), f"MoE SP launches {rec}")
        check(abs(sp_loss.item() - ref_loss.item())
              <= STEP_LOSS_RTOL * abs(ref_loss.item()), f"MoE SP loss {rec}")
        check(ok, f"MoE SP gradients {rec}")
    finally:
        dist.destroy_process_group()
    return total


def phase_cnn(frames3):
    """(c) cnn1 and cnn2 on seeded random weights: fp32 and bf16 predict at
    480px against the CPU, one train-mode fp32 step at 240px against the
    CPU (loss, gradients, running stats), peak memory at batch 3.  No
    kernel of ours runs here: the counts must stay 0."""
    zero_counts()
    for variant in ("cnn1", "cnn2"):
        model = DINOSeg(backbone=variant, head="mlp", n_classes=7,
                        precision="fp32", random_init=True, seed=3,
                        freeze_backbone=False)
        rec = {"phase": "item8", "part": "c", "backbone": variant,
               "res": 480,
               "tpu_kernel_counterparts": "none: dino_tpu's ResNet runs "
                                          "XLA convs, the port cuDNN's"}
        for prec in ("fp32", "bf16"):
            cpu = cpu_twin(model, precision=prec)
            got = model.predict_batch(frames3[:1], precision=prec)
            want = cpu.predict_batch(frames3[:1])
            logp = cpu.log_probs(torch.from_numpy(frames3[:1]))
            card_logp = model.log_probs(torch.from_numpy(
                frames3[:1]).cuda(), precision=prec).cpu()
            n_diff, n_far = labels_agree(got, want, near_ties(
                logp, CNN_MARGIN[prec]), 60)
            rec[prec] = {"patches_differing_vs_cpu": n_diff,
                         "of_them_away_from_near_ties": n_far,
                         "logp_max_abs_diff": (card_logp - logp).abs().max(
                         ).item(), "near_tie_margin": CNN_MARGIN[prec]}
            check(n_far == 0, f"{variant} {prec} labels vs CPU {rec}")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for prec in ("fp32", "bf16"):
            model.predict_batch(frames3, precision=prec)
        torch.cuda.synchronize()
        rec["predict_batch3_peak_bytes_over_weights"] = (
            torch.cuda.max_memory_allocated() - base)
        # one train-mode fp32 step at 240px: BatchNorm on batch statistics,
        # running stats written back.  The CPU step replays the card's ReLU
        # choices (backbone and head): a unit at 0 within float32 rounding
        # takes either side, and the train-mode BatchNorm backward carries
        # such a flip far (the first card run of this check, without the
        # replay, read 1.9e-2 of a cnn1 leaf's max; with it the leaves agree
        # to ~1e-5, and tests/test_torch_port_resnet.py::
        # test_cpu_step_gradients_against_float64 holds the CPU's float32
        # step to float64 the same way)
        cpu = cpu_twin(model, precision="fp32")
        masks = []
        with head_relu(record=masks):
            loss, _ = train_run(model, False, "fp32", 240, 2, 1, 1,
                                (0, 0, 0, 0), seed=4)
        with head_relu(replay=masks) as flips:
            phase_train_cpu_reference(model, cpu, loss.item(), seed=4,
                                      phase=f"{variant}_train",
                                      floor_rel=CNN_GRAD_FLOOR)
        rec["relu_units_replayed_on_cpu"] = sum(flips)
        card_bufs = dict(model.model.named_buffers())
        cpu_bufs = dict(cpu.model.named_buffers())
        stats_rel = 0.0
        for k, var in cpu_bufs.items():
            if not k.endswith("running_var"):
                continue
            k_mean = k[:-len("var")] + "mean"
            mean, var = cpu_bufs[k_mean].double(), var.double()
            d_var = (card_bufs[k].cpu().double() - var).abs() / var
            d_mean = ((card_bufs[k_mean].cpu().double() - mean).abs()
                      / torch.maximum(mean.abs(), var.sqrt()))
            stats_rel = max(stats_rel, d_var.max().item(),
                            d_mean.max().item())
        rec["train_running_stats_worst_rel_diff"] = stats_rel
        rec["launches"] = all_counts()
        emit(rec)
        check(stats_rel <= CNN_STATS_REL, f"{variant} running stats {rec}")
        check(not any(rec["launches"].values()),
              f"{variant} launched a kernel of ours {rec}")


def phase_item8(model, frames3):
    """Phase 11: (a) int8, (b) MoE, (c) cnn1/cnn2; returns the launch
    counts of (a) and (b)."""
    t0 = time.perf_counter()
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        add_counts(total, phase_int8(model, frames3, tmp))
    add_counts(total, phase_moe(model, frames3))
    phase_cnn(frames3)
    emit({"phase": "item8", "launches": total,
          "seconds": time.perf_counter() - t0})
    model.set_resolution(480)
    return total

# ---------------------------------------------------------------------------
# Phase 12: DINO pretraining (the student/teacher multi-crop step, the CLI)
# ---------------------------------------------------------------------------

# (B*nh, N) of the pretrain step's attention at batch 16, ViT-S/8 (6 heads):
# the local views (8 x 16 crops of 96 px, 145 tokens) and the global views
# (2 x 16 crops of 224 px, 785 tokens); both leave a 17-row tail past the
# kernels' 128-row blocks
PRETRAIN_ATTN = ((768, 145), (192, 785))
PRETRAIN_BATCH = 16
PRETRAIN_LR, PRETRAIN_WD = 5e-4, 0.04  # the CLI's base lr and first wd
PRETRAIN_TT, PRETRAIN_M = 0.04, 0.996  # the CLI's teacher temp, momentum
# card step vs the port's CPU step, same weights and crops (depth 2, batch
# 2, DinoConfig's widths): the loss and each clipped gradient leaf against
# its largest |g| as the fp32 train step (STEP_LOSS_RTOL, STEP_GRAD_REL);
# the post-step student as tests/test_torch_port_dino_step.py holds the
# port to dino_tpu: Adam turns a gradient within rounding of 0 into a step
# of up to lr, so no entry past 2.1 lr and at most PRETRAIN_FLIP_SHARE of
# them past 0.02 lr; the teacher by (1 - m) of that, the centre absolutely
PRETRAIN_FLIP_SHARE = 1e-3
PRETRAIN_CENTER_ATOL = 1e-6
PRETRAIN_DEPTH = 12


def pretrain_want(depth, bf16=False, fsdp=False):
    """The launches of one pretrain step at ``depth`` blocks: per block the
    student's forward for each resolution group (2 groups) and the
    teacher's (the global group only), 3 forwards, and the student's 2
    backwards; in bf16 on the bf16 kernels, with the teacher's MLP (no
    gradient) on the fused kernel.  Under FSDP each student block's
    backward recomputes its 2 forwards first: 5 forwards a block."""
    fwd, bwd = (5 if fsdp else 3) * depth, 2 * depth
    return {"flash_attn_fwd": fwd, "flash_attn_fwd_f32": 0 if bf16 else fwd,
            "fused_ln_mlp": depth if bf16 else 0,
            "flash_attn_bwd": bwd if bf16 else 0,
            "flash_attn_bwd_f32": 0 if bf16 else bwd,
            "flash_attn_fwd_dyn": 0, "flash_attn_bwd_dyn": 0}


def pretrain_attention_rows():
    """(a) kernels 1 and 3 at the pretrain shapes, f32 and bf16, against
    their plain versions (each run twice, the same bits), timed beside
    SDPA's forward and backward as kernel_times times them, with the
    bound; then the fused MLP at the bf16 step's teacher rows."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        route = "tf32" if dtype == torch.float32 else dtype
        name = str(dtype).split(".")[1]
        atol, rtol = FLASH_TOL[dtype]
        for bh, n in PRETRAIN_ATTN:
            q, k, v, do, out, lse = bwd_inputs(bh, n, dtype, seed=bh + n)
            again, lse2 = flash_attention(q, k, v, SCALE, return_lse=True)
            ref, ref_lse = attention_plain(q, k, v, SCALE)
            f_err = (out.float() - ref.float()).abs()
            f_ok = bool((f_err <= atol + rtol * ref.float().abs()).all())
            got = flash_attention_bwd(q, k, v, out, lse, do, SCALE)
            got2 = flash_attention_bwd(q, k, v, out, lse, do, SCALE)
            torch.cuda.synchronize()
            b_errs, b_ok = bwd_err(got, attention_bwd_plain(
                q, k, v, out, lse, do, SCALE), dtype)
            b, nh, _, hd = q.shape
            f_bound = bound_ms(4 * n * n * hd * b * nh,
                               4 * b * nh * n * hd * q.element_size(), route)
            fwd = kernel_times(lambda: flash_attention(q, k, v, SCALE))
            sdpa = library_times(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=SCALE))
            rec = {"phase": "pretrain", "part": "a", "dtype": name, "bh": bh,
                   "n": n,
                   "fwd_max_abs_err": f_err.max().item(),
                   "fwd_lse_max_abs_err": (lse - ref_lse).abs().max().item(),
                   "bwd_max_abs_err": max(b_errs),
                   "same_bits_twice": bool(
                       torch.equal(out, again) and torch.equal(lse, lse2)
                       and all(torch.equal(x, y) for x, y in zip(got, got2))),
                   "fwd_tol": [atol, rtol, LSE_ATOL],
                   "bwd_tol": (list(BWD_F32_TOL) if dtype == torch.float32
                               else f"{BWD_BF16_REL} x max|ref| per tensor"),
                   "fwd_kernel_ms": fwd["ms"],
                   "fwd_kernel_ms_eager": fwd["ms_eager"],
                   "fwd_sdpa_ms": sdpa["library_ms"],
                   "fwd_sdpa_ms_eager": sdpa["library_ms_eager"],
                   "fwd_bound_ms": f_bound[0], "fwd_bound_by": f_bound[1]}
            del q, k, v, do, out, lse, again, lse2, ref, f_err, got, got2
            bwd = bwd_row(bh, n, dtype, seed=bh + n)
            rec.update(bwd_kernel_ms=bwd["ms"], bwd_kernel_ms_eager=bwd[
                "ms_eager"], bwd_sdpa_ms=bwd["library_ms"],
                bwd_sdpa_ms_eager=bwd["library_ms_eager"],
                bwd_bound_ms=bwd["bound_ms"], bwd_bound_by=bwd["bound_by"])
            emit(rec)
            rows.append(rec)
            check(f_ok, f"pretrain-shape flash forward {rec}")
            check(rec["fwd_lse_max_abs_err"] <= LSE_ATOL,
                  f"pretrain-shape flash lse {rec}")
            check(b_ok, f"pretrain-shape flash backward {rec}")
            check(rec["same_bits_twice"], f"pretrain-shape bits {rec}")
    # the bf16 step's teacher (no gradient) runs the fused MLP on every
    # global token of the batch: 2 views x PRETRAIN_BATCH x 785 rows, with
    # a pretrain teacher block's float32 masters
    _, teacher = init_dino_params(torch.Generator().manual_seed(14),
                                  vit_small(patch_size=8), DinoConfig(),
                                  depth=1)
    block = teacher.vit.blocks[0]
    check_mlp(block.norm2, block.mlp, 2 * PRETRAIN_BATCH * 785,
              torch.Generator(device="cuda").manual_seed(17))
    return rows


def pretrain_crops(seed, batch, cfg):
    rs = np.random.RandomState(seed)
    g = rs.randint(0, 256, (2, batch, cfg.global_size, cfg.global_size, 3))
    l = rs.randint(0, 256, (cfg.n_local_crops, batch, cfg.local_size,
                            cfg.local_size, 3))
    return (torch.from_numpy(g.astype(np.uint8)),
            torch.from_numpy(l.astype(np.uint8)))


def pretrain_step_vs_cpu():
    """(b) one f32 step on the card against the port's CPU step from the
    same weights and crops: loss, clipped gradients, post-step student,
    teacher and centre.  Returns the card step's launch counts."""
    vit_cfg, cfg = vit_small(patch_size=8), DinoConfig()
    student, teacher = init_dino_params(torch.Generator().manual_seed(12),
                                        vit_cfg, cfg, depth=2)
    cpu_s, cpu_t = copy.deepcopy(student).cpu(), copy.deepcopy(teacher).cpu()
    g, l = pretrain_crops(13, 2, cfg)
    out = {}
    for dev, (s, t) in (("cuda", (student, teacher)), ("cpu", (cpu_s, cpu_t))):
        opt = make_dino_optimizer(s, PRETRAIN_LR, PRETRAIN_WD)
        center = torch.zeros(1, cfg.out_dim, device=dev)
        step = make_dino_train_step(vit_cfg, cfg)
        zero_counts()
        loss = step(s, t, center, opt, g.to(dev), l.to(dev), PRETRAIN_TT,
                    PRETRAIN_M, 0.0)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = all_counts()
        out[dev] = (loss.item(), center.cpu())
    g_worst, g_leaf = 0.0, None
    for (name, a), b in zip(student.named_parameters(), cpu_s.parameters()):
        rel = ((a.grad.cpu() - b.grad).abs().max().item()
               / max(b.grad.abs().max().item(), 1e-30))
        if rel >= g_worst:
            g_worst, g_leaf = rel, name
    ok = g_worst <= STEP_GRAD_REL
    p_errs = [(a.detach().cpu() - b.detach()).abs()
              for a, b in zip(student.parameters(), cpu_s.parameters())]
    p_max = max(e.max().item() for e in p_errs)
    p_far = (sum(int((e > 0.02 * PRETRAIN_LR).sum()) for e in p_errs)
             / sum(e.numel() for e in p_errs))
    t_max = max((a.detach().cpu() - b).abs().max().item()
                for a, b in zip(teacher.parameters(), cpu_t.parameters()))
    c_max = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    rec = {"phase": "pretrain", "part": "b", "depth": 2, "batch": 2,
           "out_dim": cfg.out_dim, "loss_card": out["cuda"][0],
           "loss_cpu": out["cpu"][0], "grad_worst_rel_diff": g_worst,
           "grad_worst_leaf": g_leaf,
           "student_max_abs_diff_over_lr": p_max / PRETRAIN_LR,
           "student_share_past_0.02_lr": p_far,
           "teacher_max_abs_diff": t_max, "center_max_abs_diff": c_max,
           "launches": counts,
           "tol": {"loss_rtol": STEP_LOSS_RTOL,
                   "grad_rel_per_leaf": STEP_GRAD_REL,
                   "student": "2.1 lr, share past 0.02 lr "
                              f"<= {PRETRAIN_FLIP_SHARE}",
                   "teacher": "2.1 (1 - m) lr",
                   "center_atol": PRETRAIN_CENTER_ATOL}}
    emit(rec)
    check(abs(out["cuda"][0] - out["cpu"][0])
          <= STEP_LOSS_RTOL * abs(out["cpu"][0]), f"pretrain loss {rec}")
    check(ok, f"pretrain clipped gradients card vs CPU {rec}")
    check(p_max <= 2.1 * PRETRAIN_LR and p_far <= PRETRAIN_FLIP_SHARE,
          f"pretrain student card vs CPU {rec}")
    check(t_max <= 2.1 * (1 - PRETRAIN_M) * PRETRAIN_LR,
          f"pretrain teacher card vs CPU {rec}")
    check(c_max <= PRETRAIN_CENTER_ATOL, f"pretrain centre card vs CPU {rec}")
    check(counts == pretrain_want(2), f"pretrain depth-2 launches {rec}")
    return counts


def kernel_kinds(kernels):
    """Device ms of a profiled call summed by kind: our flash kernels by
    name, the dense layers' GEMMs (cuBLAS, CUTLASS and cuBLAS's nvjet
    kernels), the rest."""
    kinds = {}
    for k in kernels:
        name = k["name"]
        kind = next((f for f in ("flash_fwd_f32", "flash_fwd_bf16",
                                 "flash_bwd_f32", "flash_bwd_bf16",
                                 "fused_ln_mlp_kernel") if f in name), None)
        if kind is None:
            kind = ("gemm" if any(g in name for g in ("gemm", "gemv", "nvjet"))
                    else "other")
        kinds[kind] = kinds.get(kind, 0.0) + k["ms"]
    return kinds


def pretrain_full_width():
    """(c) ViT-S/8, 12 blocks, DinoConfig() (out_dim 65,536, 2 x 224 + 8 x
    96 px), batch 16: f32 as the CLI runs it, one warm-up and 3 timed
    steps, then bf16 (one warm-up, one timed), each followed by one
    profiled step.  Exact launches per step.  Returns the phase's launch counts."""
    vit_cfg, cfg = vit_small(patch_size=8), DinoConfig()
    student, teacher = init_dino_params(torch.Generator().manual_seed(14),
                                        vit_cfg, cfg, depth=PRETRAIN_DEPTH)
    opt = make_dino_optimizer(student, PRETRAIN_LR, PRETRAIN_WD)
    center = torch.zeros(1, cfg.out_dim, device="cuda")
    g, l = (t.cuda() for t in pretrain_crops(15, PRETRAIN_BATCH, cfg))
    total = {}
    rec = {"phase": "pretrain", "part": "c", "depth": PRETRAIN_DEPTH,
           "batch": PRETRAIN_BATCH, "out_dim": cfg.out_dim,
           "views": "2 x 224 + 8 x 96 px"}
    for prec, cdt, timed in (("fp32", None, 3), ("bf16", torch.bfloat16, 1)):
        want = pretrain_want(PRETRAIN_DEPTH, bf16=cdt is not None)
        step = make_dino_train_step(vit_cfg, cfg, compute_dtype=cdt)

        def one():
            return step(student, teacher, center, opt, g, l, PRETRAIN_TT,
                        PRETRAIN_M, 0.0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(1 + timed):
            zero_counts()
            t0 = time.perf_counter()
            loss = one()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            got = all_counts()
            add_counts(total, got)
            losses.append(loss.item())
            check(got == want, f"pretrain {prec} step launches {got}, "
                               f"want {want}")
        host_ms = float(np.median(times[1:]))
        r = {"step_host_ms": times, "host_ms": host_ms,
             "images_per_s": PRETRAIN_BATCH / host_ms * 1e3,
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "launches_per_step": want, "losses": losses}
        zero_counts()
        bd = bench.device_breakdown(one, 1, host_ms, top=10 ** 6)
        add_counts(total, all_counts())
        r.update(device_busy_ms=bd["device_busy_ms"],
                 device_idle_share=bd["device_idle_share"],
                 device_ms_by_kind=kernel_kinds(bd["kernels"]),
                 top_kernels=bd["kernels"][:10])
        rec[prec] = r
        check(all(np.isfinite(losses)), f"pretrain {prec} loss {r}")
    emit(rec)
    del student, teacher, opt
    return total


def pretrain_cli(tmp):
    """(d) python -m dino_tpu_torch.cli.pretrain_dino on the card (depth 1,
    small views, one epoch) on JPEGs written here, then
    DINOSeg(pretrained_path=<its npz>).predict on the card."""
    from PIL import Image
    data, write = os.path.join(tmp, "imgs"), os.path.join(tmp, "out")
    os.makedirs(data)
    rs = np.random.RandomState(16)
    for i in range(4):
        Image.fromarray(rs.randint(0, 256, (120, 160, 3)).astype(
            np.uint8)).save(os.path.join(data, f"{i}.jpg"), quality=90)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dino_tpu_torch.cli.pretrain_dino",
         "--data_path", data, "--write_path", write, "--depth", "1",
         "--epochs", "1", "--warmup_epochs", "0", "--batch_size", "2",
         "--n_local_crops", "2", "--global_size", "64", "--local_size", "32",
         "--out_dim", "1024"], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)), timeout=300)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"pretrain_dino CLI failed: {proc.stderr}")
    npz = os.path.join(write, "dino_pretrained_backbone.npz")
    model = DINOSeg(head="linear", n_blocks=1, n_classes=7, seed=0,
                    precision="fp32", pretrained_path=npz)
    model.set_resolution(480)
    labels = model.predict(rs.randint(0, 256, (480, 640, 3)).astype(
        np.uint8))
    rec = {"phase": "pretrain", "part": "d", "cli_seconds": cli_s,
           "cli_stdout": proc.stdout.strip().splitlines(),
           "crop_rung": ("native" if native_loader.get_lib() is not None
                         else "cv2"),
           "predict_shape": list(labels.shape),
           "labels_in_range": bool(((labels >= 0) & (labels < 7)).all())}
    emit(rec)
    check(rec["predict_shape"] == [480, 480] and rec["labels_in_range"],
          f"DINOSeg on the pretrained backbone {rec}")


def phase_pretrain():
    """Phase 12: (a) kernels 1 and 3 at the pretrain shapes and the fused
    MLP at the bf16 teacher's, (b) the card step against the CPU step, (c)
    the full-width step, (d) the CLI.  Returns the launch counts of (b)
    and (c)."""
    t0 = time.perf_counter()
    rows = pretrain_attention_rows()
    total = {}
    add_counts(total, pretrain_step_vs_cpu())
    add_counts(total, pretrain_full_width())
    with tempfile.TemporaryDirectory() as tmp:
        pretrain_cli(tmp)
    emit({"phase": "pretrain", "launches": total,
          "seconds": time.perf_counter() - t0})
    return total, rows


# ---------------------------------------------------------------------------
# Phase 13: training over ranks (data parallelism, ZeRO-1, FSDP, the SP fit,
# DINO pretraining over ranks)
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_RANK_TIMEOUT = 900  # seconds for the rank processes, from their start
# (a) the bench config: global batch 16 in microbatches of 2 (the train
# bench's microbatch shapes; 8 a rank in 4 of them over 2 ranks), 3 Adam
# steps
DP_BATCH, DP_MICRO, DP_STEPS, DP_LR = 16, 2, 3, 1e-5
DP_F32_RES, DP_F32_BATCH = 240, 4   # (b)
DP_SP_FRAMES = {"train": 2, "val": 2, "test": 2}  # (b)'s SP fit, 240x320
DP_FIT_ACCUM = 4   # (c): 8 a rank, microbatches of 2 as phase 9 (a)'s
DP_PRETRAIN_STEPS = 2  # (d): timed steps after one warm-up
# ZeRO-1 sums the same gradients and updates each element as plain DP does,
# so it must keep DP's bits; FSDP may part from DP by this share of DP's own
# largest displacement from the initial weights (Adam's first step moves
# each entry with a gradient by about lr, so that displacement is >= lr).
# That holds where FSDP's sums are DP's: two ranks, whose sum has one order
# (FSDP reduces each unit once a step, its microbatches added in DP's
# order).  Over more ranks a reduce-scatter and DP's all-reduce add in
# other orders, and over a few Adam steps (bf16 ones especially) those
# rounding differences grow into parameter differences of a share of lr,
# so there FSDP is held to what a wrong reduction would break
# (fsdp_vs_dp): its first step's gradients within STEP_GRAD_REL of each
# leaf's max of DP's (a sum off by the group's size, or a slice from the
# wrong rank, fails it), and no parameter parting from DP's by more than
# 2.1 lr a step (Adam moves an entry by about lr a step at most).  The
# share of entries past 0.02 lr a step is recorded (2.4% in (a) on four
# NVIDIA H100 80GB HBM3 cards at 700 W, one rank a card).
DP_FSDP_PART = 1e-3
# (d): FSDP's peak must fall below DP's by at least this share of DP's state
# bytes between steps (student, teacher, gradients, moments): half of the
# (1 - 1/W) share sharding removes at W = 2
DP_FSDP_PEAK_FALL = 0.25


@contextlib.contextmanager
def collective_timer():
    """Milliseconds a step spends in its collectives (host clock, the card
    synchronized before and after each call), by kind: the all-reduces of
    the train steps ("grad_all_reduce": DP's gradients, the loss and
    confusion matrix sums, the clip norms' sum), FSDP's unit gradient
    reduce-scatters ("grad_reduce_scatter") and the parameter all-gathers
    of ZeRO-1 and FSDP's units ("param_all_gather", the moments' for a
    resume file included)."""
    from dino_tpu_torch.parallel import mesh as mesh_mod
    from dino_tpu_torch.train import dino_pretrain as pretrain_mod
    from dino_tpu_torch.train import loop as loop_mod
    spent = {"grad_all_reduce": 0.0, "grad_reduce_scatter": 0.0,
             "param_all_gather": 0.0}
    sites = [(loop_mod, "all_reduce_sum_", "grad_all_reduce"),
             (pretrain_mod, "all_reduce_sum_", "grad_all_reduce"),
             (mesh_mod, "all_reduce_sum_", "grad_all_reduce"),
             (mesh_mod, "all_gather_flat", "param_all_gather"),
             (mesh_mod, "all_gather_into", "param_all_gather"),
             (mesh_mod, "reduce_scatter_sum", "grad_reduce_scatter")]
    reals = [getattr(mod, name) for mod, name, _ in sites]

    def timed(real, kind):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **k)
            torch.cuda.synchronize()
            spent[kind] += (time.perf_counter() - t0) * 1e3
            return out
        return call
    for (mod, name, kind), real in zip(sites, reals):
        setattr(mod, name, timed(real, kind))
    try:
        yield spent
    finally:
        for (mod, name, _), real in zip(sites, reals):
            setattr(mod, name, real)


def max_abs_diff(a, b):
    """The largest |a - b| over two lists of tensors."""
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def fsdp_vs_dp(world, finals, first_grads, init, lr_step, n_steps):
    """FSDP's final parameters (and first step's gradients) against DP's:
    a record, and whether it passes DP_FSDP_PART (two ranks) or, over more
    ranks, the gradient and 2.1 lr rules (see DP_FSDP_PART)."""
    moved = max_abs_diff(finals["dp"], init)
    diffs = [(a - b).abs() for a, b in zip(finals["fsdp"], finals["dp"])]
    diff = max(d.max().item() for d in diffs)
    lr_total = lr_step * n_steps
    far = (sum(int((d > 0.02 * lr_total).sum()) for d in diffs)
           / sum(d.numel() for d in diffs))
    g_worst, g_leaf = grads_vs(first_grads["fsdp"], first_grads["dp"])
    rec = {"same_bits": diff == 0.0, "max_abs_diff": diff,
           "dp_moved_from_init": moved, "grad_worst_rel_diff": g_worst,
           "grad_worst_leaf": g_leaf, "share_past_0.02_lr": far}
    if world == 2:
        rec.update(rule="DP_FSDP_PART", bound=DP_FSDP_PART * moved)
        return rec, diff <= rec["bound"]
    rec.update(rule="first-step gradients, 2.1 lr a step",
               bound=2.1 * lr_total, grad_tol=STEP_GRAD_REL)
    return rec, diff <= rec["bound"] and g_worst <= STEP_GRAD_REL


def replicas_same(tensors):
    """Whether every rank holds the same bits of ``tensors`` (a digest per
    rank, all-gathered)."""
    import hashlib
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    mine = torch.tensor([int.from_bytes(h.digest()[:8], "little",
                                        signed=True)], device="cuda")
    got = pdist.all_gather_flat(mine)
    return bool((got == got[0]).all())


def state_bytes(opt, params):
    """A rank's resident bytes of trainable parameters, gradients and
    optimizer moments (a sharded optimizer counts its own)."""
    if isinstance(opt, (ShardedOptimizer, FSDPOptimizer)):
        return opt.resident_bytes()
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    return {"params": nbytes(params),
            "grads": nbytes([p.grad for p in params if p.grad is not None]),
            "moments": nbytes([v for st in opt.state.values()
                               for v in st.values() if torch.is_tensor(v)
                               and v.dim() > 0])}


def named_grads(model, opt):
    """{name: full gradient} of the model's trainable parameters: .grad, or
    a sharded optimizer's shard gradients gathered whole."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if isinstance(opt, FSDPOptimizer):
        by_id = {id(p): g for p, g in zip(opt.params, opt.gathered_grads())}
        return {n: by_id[id(p)] for n, p in named}
    if not isinstance(opt, ShardedOptimizer):
        return {n: p.grad for n, p in named}
    full = opt.shards._gather_flat([sh.grad for sh in opt.shards.shards])
    by_id = {id(p): g.view(s) for p, g, s in zip(opt.params, full,
                                                  opt.shards.shapes)}
    return {n: by_id[id(p)] for n, p in named}


def grads_vs(got, ref):
    """(worst relative difference, its leaf): each leaf's max |diff|
    against its reference's max |g|."""
    worst, leaf = 0.0, None
    for n, r in ref.items():
        rel = ((got[n] - r).abs().max().item()
               / max(r.abs().max().item(), 1e-30))
        if rel >= worst:
            worst, leaf = rel, n
    return worst, leaf


def dp_kernel_checks():
    """The kernels the ranks launch, against their plain versions at the
    ranks' shapes that phases 3, 6 and 12 do not cover: the forward at
    B*nh = 12 ((b)'s fp32 240px slab, (c)'s bf16 microbatch), the f32
    forward and backward at the pretrain slab's (96, 785) and (384, 145),
    the dynamic-bound pair at (b)'s 2-rank 240px hop (12, 451) and the
    fused MLP at (c)'s eval slab (2 x 3,601 rows)."""
    for dtype, bh, n in ((torch.float32, 12, 901), (torch.bfloat16, 12, 3601),
                         (torch.float32, 96, 785), (torch.float32, 384, 145)):
        atol, rtol = FLASH_TOL[dtype]
        q, k, v, do, out, lse = bwd_inputs(bh, n, dtype, seed=bh + n + 3)
        ref, ref_lse = attention_plain(q, k, v, SCALE)
        err = (out.float() - ref.float()).abs()
        got = flash_attention_bwd(q, k, v, out, lse, do, SCALE)
        torch.cuda.synchronize()
        b_errs, b_ok = bwd_err(got, attention_bwd_plain(q, k, v, out, lse, do,
                                                        SCALE), dtype)
        rec = {"phase": "dp", "part": "kernel_check", "kernel":
               "flash_attn_fwd + flash_attn_bwd", "dtype": str(dtype)[6:],
               "bh": bh, "n": n, "fwd_max_abs_err": err.max().item(),
               "lse_max_abs_err": (lse - ref_lse).abs().max().item(),
               "bwd_max_abs_err": max(b_errs)}
        emit(rec)
        check(bool((err <= atol + rtol * ref.float().abs()).all()),
              f"flash forward at a rank's shape {rec}")
        check(rec["lse_max_abs_err"] <= LSE_ATOL, f"flash lse {rec}")
        check(b_ok, f"flash backward at a rank's shape {rec}")
        del q, k, v, do, out, lse, ref, ref_lse, err, got
    n, bounds = sp_shapes(DP_F32_RES ** 2 // 64 + 1, DP_WORLD)
    q, k, v = flash_inputs(12, n, torch.float32, seed=n)
    g = torch.Generator(device="cuda").manual_seed(n + 1)
    do = torch.randn(q.shape, generator=g, device="cuda")
    for valid in bounds:
        if not valid:
            continue
        out, lse = flash_attention_with_lse_dyn(q, k, v, SCALE, valid)
        ref, ref_lse = attention_dyn_plain(q, k, v, SCALE, valid)
        dsum = (do * ref).sum(-1).reshape(12, n)
        got = flash_attention_bwd_dyn(q, do, ref_lse, dsum, k, v, SCALE,
                                      valid)
        torch.cuda.synchronize()
        b_errs, b_ok = bwd_dyn_err(got, attention_bwd_dyn_plain(
            q, do, ref_lse, dsum, k, v, SCALE, valid), torch.float32)
        err = (out - ref).abs()
        rec = {"phase": "dp", "part": "kernel_check",
               "kernel": "flash_attn_fwd_dyn + flash_attn_bwd_dyn",
               "dtype": "float32", "bh": 12, "n_local": n, "valid": valid,
               "fwd_max_abs_err": err.max().item(),
               "bwd_max_abs_err": max(b_errs)}
        emit(rec)
        atol, rtol = FLASH_TOL[torch.float32]
        check(bool((err <= atol + rtol * ref.abs()).all()),
              f"dyn forward at a rank's hop {rec}")
        check(b_ok, f"dyn backward at a rank's hop {rec}")
    block = sp_model("bf16").model.dino.blocks[0]
    check_mlp(block.norm2, block.mlp, 2 * 3601,
              torch.Generator(device="cuda").manual_seed(23))


def dp_bench_steps(rank, world, backend):
    """(a) the bench config over the ranks: plain DP, ZeRO-1 and FSDP,
    one warm-up and DP_STEPS timed steps each from the same weights and
    batch, the collectives timed; after each step the ranks hold the same
    bits.  Each step's peak memory (the peak reset before it); FSDP's must
    be below DP's, and its most-gathered bytes at most two units'.
    Returns the launch counts."""
    group = dist.group.WORLD
    rs = np.random.RandomState(21)
    imgs = rs.randint(0, 255, (DP_BATCH, FIT_RES, FIT_RES, 3)).astype(
        np.uint8)
    labels = rs.randint(0, 7, (DP_BATCH, (FIT_RES // 8) ** 2)).astype(
        np.int32)
    b_loc = DP_BATCH // world
    accum = max(1, b_loc // DP_MICRO)
    rows = slice(rank * b_loc, (rank + 1) * b_loc)
    x, y = (torch.from_numpy(a[rows]).cuda() for a in (imgs, labels))
    per_step = 3 * accum  # 3 blocks a microbatch
    total, finals, peaks, first_grads = {}, {}, {}, {}
    for mode in ("dp", "zero", "fsdp"):
        # FSDP's backward recomputes each block's forward
        want = launches_want(fwd=per_step * (2 if mode == "fsdp" else 1),
                             bwd=per_step)
        m = sp_model("bf16")
        vit, head = m.model.dino, m.model.clf
        meshes = dict(zero_mesh=group if mode == "zero" else None,
                      fsdp_mesh=group if mode == "fsdp" else None)
        optimizer = make_optimizer("adam", DP_LR)
        opt = init_opt_state(optimizer, vit, head, False, **meshes)
        step = make_train_step(m.cfg, "mlp", 7, optimizer, False,
                               compute_dtype=torch.bfloat16,
                               accum_steps=accum, dp_group=group, **meshes)
        params = list(m.model.parameters())
        if mode == "dp":
            init = [p.detach().clone() for p in params]
        host, coll, same, losses, step_peaks, books = [], [], [], [], [], []
        for _ in range(1 + DP_STEPS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if mode == "fsdp":
                opt.book.reset()
            with collective_timer() as spent:
                t0 = time.perf_counter()
                (loss, _), got = counted(lambda: step(vit, head, opt, x, y))
                host.append((time.perf_counter() - t0) * 1e3)
            step_peaks.append(torch.cuda.max_memory_allocated())
            coll.append(spent)
            if mode == "fsdp":
                books.append(opt.book.as_dict())
            add_counts(total, got)
            check(got == want, f"DP {mode} step launches {got}, want {want}")
            losses.append(loss.item())
            if mode != "zero" and mode not in first_grads:
                first_grads[mode] = {n: g.clone() for n, g in
                                     named_grads(m.model, opt).items()}
            between = state_bytes(opt, params)
            materialize(opt)
            same.append(replicas_same(params))
            if mode == "fsdp":
                opt.release()
        peaks[mode] = max(step_peaks)
        rec = {"phase": "dp", "part": "a bench config", "mode": mode,
               "rank": rank, "world": world, "backend": backend,
               "res": FIT_RES, "blocks": 3, "global_batch": DP_BATCH,
               "rank_batch": b_loc, "accum_steps": accum,
               "host_ms_per_step": host,
               "host_ms": float(np.median(host[1:])),
               "collective_ms_per_step": coll,
               "peak_bytes": peaks[mode], "peak_bytes_per_step": step_peaks,
               "state_bytes_between_steps": between,
               "losses": losses, "replicas_same_bits": same,
               "launches_per_step": want}
        if mode == "fsdp":
            units = sorted(u.full_bytes for u in opt.units)
            rec.update(unit_books=books, unit_full_bytes=units)
            check(all(bk["peak_gathered_bytes"] <= units[-1] + units[-2]
                      and bk["peak_grad_bytes"] <= units[-1]
                      for bk in books), f"DP fsdp gathered more than two "
                                        f"units at once {rec}")
        emit(rec)
        check(all(same), f"DP {mode}: the ranks' parameters part {rec}")
        check(all(np.isfinite(losses)), f"DP {mode} loss {rec}")
        materialize(opt)
        finals[mode] = [p.detach().clone() for p in params]
        del m, vit, head, opt, step, params
        torch.cuda.empty_cache()
    moved = max_abs_diff(finals["dp"], init)
    check(moved >= DP_LR, f"DP's parameters moved {moved} < lr {DP_LR}")
    diff = max_abs_diff(finals["zero"], finals["dp"])
    rec = {"phase": "dp", "part": "a vs plain DP", "mode": "zero",
           "rank": rank, "same_bits": diff == 0.0, "max_abs_diff": diff,
           "dp_moved_from_init": moved, "bound": 0.0,
           "peak_bytes": peaks["zero"], "dp_peak_bytes": peaks["dp"]}
    emit(rec)
    check(diff == 0.0, f"DP zero parts from plain DP {rec}")
    part, ok = fsdp_vs_dp(world, finals, first_grads, init, DP_LR,
                          1 + DP_STEPS)
    rec = dict({"phase": "dp", "part": "a vs plain DP", "mode": "fsdp",
                "rank": rank, "world": world, "peak_bytes": peaks["fsdp"],
                "dp_peak_bytes": peaks["dp"]}, **part)
    emit(rec)
    check(ok, f"DP fsdp parts from plain DP {rec}")
    check(peaks["fsdp"] < peaks["dp"],
          f"DP fsdp's peak {peaks['fsdp']} not below DP's {peaks['dp']}")
    return total


def dp_world_of_one():
    """(a) in a world of one on card 0: the bench config's global batch in
    DP_MICRO-frame microbatches, one warm-up and DP_STEPS timed steps (the
    figure the ranks' host ms scale against)."""
    rs = np.random.RandomState(21)
    x = torch.from_numpy(rs.randint(0, 255, (DP_BATCH, FIT_RES, FIT_RES, 3))
                         .astype(np.uint8)).cuda()
    y = torch.from_numpy(rs.randint(0, 7, (DP_BATCH, (FIT_RES // 8) ** 2))
                         .astype(np.int32)).cuda()
    m = sp_model("bf16")
    optimizer = make_optimizer("adam", DP_LR)
    opt = init_opt_state(optimizer, m.model.dino, m.model.clf, False)
    accum = DP_BATCH // DP_MICRO
    step = make_train_step(m.cfg, "mlp", 7, optimizer, False,
                           compute_dtype=torch.bfloat16, accum_steps=accum)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    host = []
    for _ in range(1 + DP_STEPS):
        t0 = time.perf_counter()
        (loss, _), got = counted(lambda: step(m.model.dino, m.model.clf, opt,
                                              x, y))
        host.append((time.perf_counter() - t0) * 1e3)
    want = launches_want(fwd=3 * accum, bwd=3 * accum)
    rec = {"phase": "dp", "part": "a world of one", "world": 1,
           "res": FIT_RES, "global_batch": DP_BATCH, "accum_steps": accum,
           "host_ms_per_step": host, "host_ms": float(np.median(host[1:])),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "loss": loss.item(), "launches": got}
    emit(rec)
    check(got == want, f"DP world of one launches {got}, want {want}")
    check(bool(np.isfinite(rec["loss"])), f"DP world of one loss {rec}")
    return got


def dp_f32_steps(rank, world, backend):
    """(b) fp32 at 240px, global batch 4: the DP step and the FSDP step
    against the world-of-one step on this card from the same weights and
    batch (the head's ReLU choices replayed from it, head_relu): loss
    rtol STEP_LOSS_RTOL, every gradient leaf within STEP_GRAD_REL of its
    max.  Returns the launch counts."""
    group = dist.group.WORLD
    out = DP_F32_RES // 8
    rs = np.random.RandomState(22)
    imgs = torch.from_numpy(rs.randint(0, 255, (DP_F32_BATCH, DP_F32_RES,
                                                DP_F32_RES, 3)).astype(
        np.uint8)).cuda()
    labels = torch.from_numpy(rs.randint(0, 7, (DP_F32_BATCH, out * out))
                              .astype(np.int32)).cuda()
    b_loc = DP_F32_BATCH // world
    rows = slice(rank * b_loc, (rank + 1) * b_loc)
    masks = []
    with head_relu(record=masks):
        ref_m, ref_loss, _ = one_step("fp32", imgs, labels,
                                      lambda cfg, opt, cdt: make_train_step(
                                          cfg, "mlp", 7, opt, False))
    ref = {n: p.grad for n, p in ref_m.model.named_parameters()}
    n_rows = b_loc * out * out
    local = [mk[rank * n_rows:(rank + 1) * n_rows] for mk in masks]
    total = {}
    for mode in ("dp", "fsdp"):
        m = sp_model("fp32")
        vit, head = m.model.dino, m.model.clf
        fsdp = group if mode == "fsdp" else None
        optimizer = make_optimizer("adam", 1e-5)
        opt = init_opt_state(optimizer, vit, head, False, fsdp_mesh=fsdp)
        step = make_train_step(m.cfg, "mlp", 7, optimizer, False,
                               dp_group=group, fsdp_mesh=fsdp)
        # FSDP's head runs again in its backward: the choices replayed twice
        with head_relu(replay=local * (2 if mode == "fsdp" else 1)) as flips:
            (loss, _), got = counted(lambda: step(vit, head, opt,
                                                  imgs[rows], labels[rows]))
        add_counts(total, got)
        worst, leaf = grads_vs(named_grads(m.model, opt), ref)
        # FSDP's backward recomputes each block's forward
        want = launches_want(fwd_f32=6 if mode == "fsdp" else 3, bwd_f32=3)
        rec = {"phase": "dp", "part": "b fp32 vs world of one", "mode": mode,
               "rank": rank, "world": world, "backend": backend,
               "res": DP_F32_RES, "global_batch": DP_F32_BATCH,
               "loss": loss.item(), "loss_world_of_one": ref_loss.item(),
               "grad_worst_rel_diff": worst, "grad_worst_leaf": leaf,
               "grad_tol": STEP_GRAD_REL, "head_relu_units_replayed": flips,
               "launches": got, "want": want}
        emit(rec)
        check(got == want, f"DP fp32 {mode} launches {rec}")
        check(abs(loss.item() - ref_loss.item())
              <= STEP_LOSS_RTOL * abs(ref_loss.item()), f"DP fp32 loss {rec}")
        check(worst <= STEP_GRAD_REL, f"DP fp32 {mode} gradients {rec}")
        materialize(opt)
        del m, opt, step
    return total


def dp_sp_fit(rank, world, tmp):
    """(b) one fit(parallelism='sp') epoch (one fp32 step at 240px, batch
    2) over the ranks, its step's gradients against the world-of-one SP
    step (a process group of this rank alone) from the same weights and
    batch, the head's ReLU choices replayed from it.  Returns the launch
    counts."""
    from dino_tpu_torch import api as api_mod
    splits = {k: memory_split(n, 30 + i, h=DP_F32_RES, w=320)
              for i, (k, n) in enumerate(DP_SP_FRAMES.items())}
    kw = dict(precision="fp32", freeze_backbone=False, batch_size=2,
              lr=1e-5, augmented=False, train_resolution=DP_F32_RES,
              max_epochs=1)
    ref_m = fit_model(splits, os.path.join(tmp, "sp_ref"), **kw)
    train_ds = ref_m._make_dataset(ref_m.train_path, False, DP_F32_RES)
    rng = np.random.default_rng([0, 0])
    idx = epoch_indices(rng, len(train_ds), 2)
    xb, yb = next(iter(batched_loader(train_ds, idx, 2, rng=rng)))
    x, y = torch.from_numpy(xb).cuda(), torch.from_numpy(yb).cuda()
    masks = []
    optimizer = make_optimizer("adam", 1e-5)
    vit, head = ref_m.model.dino, ref_m.model.clf
    alone = [dist.new_group([r]) for r in range(world)][rank]
    with head_relu(record=masks):
        make_sp_train_step(ref_m.cfg, "mlp", 7, optimizer, group=alone)(
            vit, head, init_opt_state(optimizer, vit, head, False), x, y)
    ref = {n: p.grad for n, p in ref_m.model.named_parameters()}
    # the recorded rows are every token's: keep the patches' (CLS is 0)
    n_real = (DP_F32_RES // 8) ** 2 + 1
    masks = [mk.reshape(2, n_real, -1)[:, 1:].reshape(2 * (n_real - 1), -1)
             for mk in masks]
    captured = {}
    real = api_mod.make_sp_train_step

    def capturing(*a, **k):
        step = real(*a, **k)

        def wrapped(vit_, head_, opt_, *rest):
            got_ = step(vit_, head_, opt_, *rest)
            captured["grads"] = {n: p.grad.clone() for n, p in
                                 model.model.named_parameters()}
            return got_
        return wrapped
    model = fit_model(splits, os.path.join(tmp, "sp"), **kw)
    api_mod.make_sp_train_step = capturing
    try:
        with head_relu(replay=masks, rows=(2, (DP_F32_RES // 8) ** 2, world,
                                           rank)) as flips:
            metrics, got = counted(lambda: model.fit(samples_per_epoch=2,
                                                     parallelism="sp"))
    finally:
        api_mod.make_sp_train_step = real
    worst, leaf = grads_vs(captured["grads"], ref)
    rec = {"phase": "dp", "part": "b SP fit vs world of one", "rank": rank,
           "world": world, "res": DP_F32_RES, "batch": 2,
           "test_acc": metrics["test_acc"], "grad_worst_rel_diff": worst,
           "grad_worst_leaf": leaf, "grad_tol": STEP_GRAD_REL,
           "head_relu_units_replayed": flips, "launches": got,
           "dyn_entry_launches": {
               "fwd": flash_attention_with_lse_dyn.launches,
               "bwd": flash_attention_bwd_dyn.launches}}
    emit(rec)
    # the step's ring (3 blocks x world hops each way), then one f32
    # forward a block for each of the val and test batches
    want = dict(sp_want(3 * world, bwd_f32=3 * world),
                flash_attn_fwd=6, flash_attn_fwd_f32=6)
    check(got == want, f"SP fit launches {got}, want {want}")
    check(worst <= STEP_GRAD_REL, f"SP fit gradients {rec}")
    return got


def dp_fit(rank, world, tmp):
    """(c) a 2-rank fit of one epoch on phase 9's in-memory bands (bf16,
    480px, global batch 16, augmented) and the ranks' evaluate of its test
    split, batch 2; the main process holds the confusion matrix to its
    world-of-one evaluate of rank 0's checkpoint.  Returns the launch
    counts."""
    splits = {name: memory_split(n, seed) for seed, (name, n) in
              enumerate(FIT_FRAMES.items())}
    model = fit_model(splits, os.path.join(tmp, "fit"), precision="bf16",
                      freeze_backbone=False, batch_size=FIT_BATCH, lr=FIT_LR,
                      augmented=True, train_resolution=FIT_RES, max_epochs=1)
    torch.cuda.reset_peak_memory_stats()
    out, got = counted(lambda: model.fit(samples_per_epoch=FIT_SAMPLES,
                                         accum_steps=DP_FIT_ACCUM))
    steps = batches(FIT_SAMPLES, FIT_BATCH)
    per_rank_eval = 2 * batches(FIT_FRAMES["val"] // world, FIT_BATCH)
    want = launches_want(fwd=3 * DP_FIT_ACCUM * steps + 3 * per_rank_eval,
                         mlp=3 * per_rank_eval,
                         bwd=3 * DP_FIT_ACCUM * steps)
    cm, got_eval = counted(lambda: model._run_eval(
        model._eval_step(), model._make_dataset(model.test_path, False,
                                                FIT_RES), 2))
    stats = pipeline_stats(model) if rank == 0 else None
    rec = {"phase": "dp", "part": "c fit", "rank": rank, "world": world,
           "res": FIT_RES, "global_batch": FIT_BATCH,
           "accum_steps": DP_FIT_ACCUM, "samples_per_epoch": FIT_SAMPLES,
           "optimizer_steps": steps, "test": out, "launches": got,
           "want": want, "epoch_host": stats,
           "evaluate_cm": cm.tolist(), "evaluate_launches": got_eval,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    emit(rec)
    check(got == want, f"DP fit launches {got}, want {want}")
    add_counts(got, got_eval)
    return got


def dp_pretrain(rank, world, tmp):
    """(d) the full-width pretrain step over the ranks, f32 as the CLI runs
    it, without and with FSDP (global batch PRETRAIN_BATCH, each rank its
    slab): one warm-up and DP_PRETRAIN_STEPS timed steps, the ranks'
    students the same bits after them, images/s, each rank's peak memory
    before the first step and over the mode, and state bytes.  FSDP builds
    both models on the host, so before its first step a rank's card holds
    at most its shards and one unit; its peak must fall below DP's by at
    least DP_FSDP_PEAK_FALL of DP's state bytes.  Then the pretrain CLI
    over the ranks at depth 1 with --fsdp on JPEGs written here.  Returns
    the launch counts."""
    from dino_tpu_torch.cli.pretrain_dino import main as pretrain_main
    group = dist.group.WORLD
    vit_cfg, cfg = vit_small(patch_size=8), DinoConfig()
    g, l = pretrain_crops(15, PRETRAIN_BATCH, cfg)
    b_loc = PRETRAIN_BATCH // world
    g, l = (t[:, rank * b_loc:(rank + 1) * b_loc].cuda() for t in (g, l))
    total, finals, recs, first_grads = {}, {}, {}, {}
    for mode in ("dp", "fsdp"):
        want = pretrain_want(PRETRAIN_DEPTH, fsdp=mode == "fsdp")
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        student, teacher = init_dino_params(
            torch.Generator().manual_seed(14), vit_cfg, cfg,
            depth=PRETRAIN_DEPTH, device="cpu" if mode == "fsdp" else None)
        opt = make_dino_optimizer(student, PRETRAIN_LR, PRETRAIN_WD)
        if mode == "dp":
            init = [p.detach().clone() for p in student.parameters()]
        if mode == "fsdp":  # only the shards reach the card
            opt = shard_dino_state(student, teacher, opt, group,
                                   device="cuda")
        before = torch.cuda.max_memory_allocated() - base
        step = make_dino_train_step(vit_cfg, cfg, dp_group=group,
                                    fsdp_mesh=group if mode == "fsdp"
                                    else None)
        center = torch.zeros(1, cfg.out_dim, device="cuda")
        times, losses, coll = [], [], []
        for _ in range(1 + DP_PRETRAIN_STEPS):
            torch.cuda.synchronize()
            with collective_timer() as spent:
                t0 = time.perf_counter()
                loss, got = counted(lambda: step(student, teacher, center,
                                                 opt, g, l, PRETRAIN_TT,
                                                 PRETRAIN_M, 0.0))
                times.append((time.perf_counter() - t0) * 1e3)
            coll.append(spent)
            losses.append(loss.item())
            add_counts(total, got)
            check(got == want, f"pretrain {mode} launches {got}, "
                               f"want {want}")
            if mode not in first_grads:  # the clipped gradients
                first_grads[mode] = {n: g.clone() for n, g in
                                     named_grads(student, opt).items()}
        peak = torch.cuda.max_memory_allocated() - base
        params = list(student.parameters())
        if mode == "fsdp":
            res = opt.resident_bytes()
            res["teacher"] = res.pop("followers")
            units = sorted(u.full_bytes for u in opt.units)
            shards = sum(u.size * 4 for u in opt.units + opt.followers)
            book = opt.book.as_dict()
        else:
            res = state_bytes(opt, params)
            res["teacher"] = sum(t.numel() * 4 for t in teacher.parameters())
        materialize(opt)
        host_ms = float(np.median(times[1:]))
        rec = {"phase": "dp", "part": "d pretrain", "mode": mode,
               "rank": rank, "world": world, "depth": PRETRAIN_DEPTH,
               "global_batch": PRETRAIN_BATCH, "rank_batch": b_loc,
               "step_host_ms": times, "host_ms": host_ms,
               "collective_ms_per_step": coll,
               "images_per_s": PRETRAIN_BATCH / host_ms * 1e3,
               "peak_bytes_before_first_step": before,
               "peak_bytes": peak,
               "state_bytes_between_steps": res,
               "state_bytes_total": sum(res.values()), "losses": losses,
               "replicas_same_bits": replicas_same(params),
               "single_process_peak_gb_phase12": 16.2,
               "launches_per_step": want}
        if mode == "fsdp":
            rec.update(shard_bytes=shards, unit_full_bytes=units,
                       unit_book=book)
            check(before <= shards + units[-1],
                  f"pretrain fsdp: more than the shards and one unit on the "
                  f"card before the first step {rec}")
            check(book["peak_gathered_bytes"] <= units[-1] + units[-2]
                  and book["peak_grad_bytes"] <= units[-1],
                  f"pretrain fsdp gathered more than two units {rec}")
        emit(rec)
        recs[mode] = rec
        check(rec["replicas_same_bits"], f"pretrain {mode} replicas {rec}")
        check(all(np.isfinite(losses)), f"pretrain {mode} loss {rec}")
        finals[mode] = [p.detach().clone() for p in params]
        del student, teacher, opt, step, center, params
    part, ok = fsdp_vs_dp(world, finals, first_grads, init, PRETRAIN_LR,
                          1 + DP_PRETRAIN_STEPS)
    fall = recs["dp"]["peak_bytes"] - recs["fsdp"]["peak_bytes"]
    rec = dict({"phase": "dp", "part": "d FSDP vs DP student",
                "rank": rank, "world": world, "peak_fall_bytes": fall,
                "peak_fall_bound": DP_FSDP_PEAK_FALL
                * recs["dp"]["state_bytes_total"]}, **part)
    emit(rec)
    check(rec["dp_moved_from_init"] >= PRETRAIN_LR,
          f"pretrain DP student did not move {rec}")
    check(ok, f"pretrain FSDP parts from DP {rec}")
    check(fall >= rec["peak_fall_bound"],
          f"pretrain FSDP's peak does not fall enough below DP's {rec}")
    del finals, init
    torch.cuda.empty_cache()
    # the CLI over the ranks: rank 0 writes the JPEGs, the barrier
    # publishes them
    data, write = os.path.join(tmp, "imgs"), os.path.join(tmp, "out")
    batch = max(2, world)  # the batch divides over the ranks
    if rank == 0:
        from PIL import Image
        os.makedirs(data)
        rs = np.random.RandomState(16)
        for i in range(2 * batch):
            Image.fromarray(rs.randint(0, 256, (120, 160, 3)).astype(
                np.uint8)).save(os.path.join(data, f"{i}.jpg"), quality=90)
    pdist.barrier()
    t0 = time.perf_counter()
    npz = pretrain_main(["--data_path", data, "--write_path", write,
                         "--depth", "1", "--epochs", "1", "--warmup_epochs",
                         "0", "--batch_size", str(batch),
                         "--n_local_crops", "2",
                         "--global_size", "64", "--local_size", "32",
                         "--out_dim", "1024", "--fsdp"])
    with np.load(npz) as z:
        finite = all(bool(np.isfinite(z[k]).all()) for k in z.files)
    rec = {"phase": "dp", "part": "d CLI over ranks", "rank": rank,
           "cli_seconds": time.perf_counter() - t0, "fsdp": True,
           "backbone_finite": finite}
    emit(rec)
    check(finite, f"pretrain CLI over ranks {rec}")
    return total


def dp_rank_main(rank, world, store, backend):
    """One rank of phase 13 (gloo over host-staged collectives with the
    kernels on a shared card, or NCCL with one card per rank, where (a),
    (b)'s DP and FSDP steps and (d) run).  Prints JSON records, the last
    one its summary."""
    pdist.init_distributed_mode(backend, f"file://{store}", world, rank)
    tmp = os.path.dirname(store)
    total = {}
    add_counts(total, dp_bench_steps(rank, world, backend))
    add_counts(total, dp_f32_steps(rank, world, backend))
    sp = {}
    if backend == "gloo":
        zero_counts()
        sp = dp_sp_fit(rank, world, tmp)
        add_counts(total, sp)
        add_counts(total, dp_fit(rank, world, tmp))
    add_counts(total, dp_pretrain(rank, world, tmp))
    dist.destroy_process_group()
    emit({"dp_rank_ok": True, "rank": rank, "launches": total,
          "sp_fit_launches": sp})


def phase_dp():
    """Phase 13: the kernels at the ranks' new shapes, then two rank
    processes sharing the card over gloo ((a)-(d)), and the world-of-one
    evaluate of the ranks' fit checkpoint against their 2-rank evaluate.
    Returns the ranks' summed launch counts."""
    t0 = time.perf_counter()
    dp_kernel_checks()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    started = start_ranks("dp", DP_WORLD, "gloo")
    summaries, records = join_ranks(started, "dp", DP_RANK_TIMEOUT)
    total = {}
    for r, s in enumerate(summaries):
        c = s["launches"]
        check(c["flash_attn_fwd"] > c["flash_attn_fwd_f32"]
              and c["flash_attn_bwd"] > 0,
              f"DP rank {r} launched no bf16 forward or backward {c}")
        check(s["sp_fit_launches"].get("flash_attn_fwd_dyn", 0) > 0
              and s["sp_fit_launches"].get("flash_attn_bwd_f32", 0) > 0,
              f"DP rank {r}'s SP fit launched no dynamic-bound kernel {s}")
        add_counts(total, c)
    # (c): the ranks' evaluate against the world of one's of rank 0's
    # checkpoint, batch 2 (the shapes each rank ran)
    tmp = os.path.dirname(started[2])
    splits = {name: memory_split(n, seed) for seed, (name, n) in
              enumerate(FIT_FRAMES.items())}
    ck = os.path.join(tmp, "fit", f"{FIT_BLOCKS}_mlp_finetuned.ckpt.npz")
    one = fit_model(splits, os.path.join(tmp, "fit_one"), precision="bf16",
                    freeze_backbone=False, train_resolution=FIT_RES)
    one.model.load_state_dict(DINOSeg.load_from_checkpoint(
        ck, device=FIT_DEVICE).model.state_dict())
    cm = one._run_eval(one._eval_step(), one._make_dataset(
        one.test_path, False, FIT_RES), 2)
    ranks_cm = [rec["evaluate_cm"] for rec in records
                if rec.get("part") == "c fit"]
    rec = {"phase": "dp", "part": "c evaluate vs world of one",
           "world_of_one_cm": cm.tolist(),
           "ranks_equal": all(c == cm.tolist() for c in ranks_cm)}
    emit(rec)
    check(len(ranks_cm) == DP_WORLD and rec["ranks_equal"],
          f"2-rank evaluate differs from the world of one {rec}")
    emit({"phase": "dp", "part": "c train frames/s",
          "two_ranks": [e["train_frames_per_s"] for rec in records
                        if rec.get("part") == "c fit" and rec["epoch_host"]
                        for e in rec["epoch_host"]],
          "world_of_one_phase9_a": FIT_A_FPS})
    emit({"phase": "dp", "rank_launches_summed": total,
          "seconds": time.perf_counter() - t0})
    shutil.rmtree(tmp, ignore_errors=True)
    return total


def dp_cards_main(world, card):
    """Phase 13's DP, ZeRO and FSDP rank checks ((a), (b), (d)) with one
    rank per card over NCCL, then (a)'s DP step in a world of one on card
    0."""
    check(torch.cuda.device_count() >= world,
          f"--dp-world {world} needs {world} cards, found "
          f"{torch.cuda.device_count()}")
    emit({"phase": "device", "names": [torch.cuda.get_device_name(i)
                                       for i in range(world)],
          "nvidia_smi": card, "torch": torch.__version__})
    _build.library()
    summaries, _ = join_ranks(start_ranks("dp", world, "nccl"), "dp",
                              DP_RANK_TIMEOUT)
    total = {}
    for s in summaries:
        add_counts(total, s["launches"])
    add_counts(total, dp_world_of_one())
    emit({"phase": "dp", "world": world, "backend": "nccl",
          "rank_launches_summed": total})
    check(total["flash_attn_bwd"] > 0, "a DP rank launched no backward")
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


# ---------------------------------------------------------------------------
# Phase 14: tensor parallelism (TP predict, DP x TP and SP x TP training)
# ---------------------------------------------------------------------------

TP_RANK_TIMEOUT = 600  # seconds for a world of rank processes, from its start
TP_PRED_RES = 480      # (a): the bench config, 480x640 frames at 480px
TP_BF16_MARGIN = 1e-2  # bf16 top-2 gap below which TP labels may differ
TP_F32_RES = 240       # (b): fp32 steps at 240px
TP_LAT_CALLS = 20      # timed predicts per reading (--tp-world)


def tp_frames(batch, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (batch, 480, 640, 3)).astype(np.uint8)


def head_inputs(b, nh, n, dtype, seed):
    """q, k, v (b, nh, N, 64) on the card: a rank's head group."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, nh, n, 64, generator=g, device="cuda").to(dtype)
            for _ in range(3)]


def tp_kernel_checks():
    """The kernels at the shapes the TP paths give them that earlier phases
    do not cover, against their plain versions: the forward (both dtypes)
    at a rank's head group of the 480px predict (B·nh_l 3 and 9, N
    3,601), the bf16 backward at the DP x TP bench microbatch (2 x 3
    heads, N 3,601), the f32 backward at the fp32 240px DP x TP slab (2 x
    3, N 901), and the dynamic-bound pair at the 2 x 2 SP x TP hop (2 x 3
    heads, 451 keys a shard) in both dtypes."""
    n480, n240 = (480 // 8) ** 2 + 1, (TP_F32_RES // 8) ** 2 + 1
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = FLASH_TOL[dtype]
        for b, nh in ((1, 3), (3, 3), (3, 1)):
            q, k, v = head_inputs(b, nh, n480, dtype, seed=b * 10 + nh)
            out, lse = flash_attention(q, k, v, SCALE, return_lse=True)
            torch.cuda.synchronize()
            ref, ref_lse = attention_plain(q, k, v, SCALE)
            err = (out.float() - ref.float()).abs()
            rec = {"phase": "tp", "part": "kernel_check",
                   "kernel": "flash_attn_fwd", "dtype": str(dtype)[6:],
                   "bh": b * nh, "n": n480, "max_abs_err": err.max().item(),
                   "lse_max_abs_err": (lse - ref_lse).abs().max().item()}
            emit(rec)
            check(bool((err <= atol + rtol * ref.float().abs()).all())
                  and rec["lse_max_abs_err"] <= LSE_ATOL,
                  f"flash forward at a TP head group {rec}")
    for dtype, n in ((torch.bfloat16, n480), (torch.float32, n240)):
        q, k, v = head_inputs(2, 3, n, dtype, seed=n)
        g = torch.Generator(device="cuda").manual_seed(n + 1)
        do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
        out, lse = flash_attention(q, k, v, SCALE, return_lse=True)
        got = flash_attention_bwd(q, k, v, out, lse, do, SCALE)
        torch.cuda.synchronize()
        errs, ok = bwd_err(got, attention_bwd_plain(q, k, v, out, lse, do,
                                                    SCALE), dtype)
        rec = {"phase": "tp", "part": "kernel_check",
               "kernel": "flash_attn_bwd", "dtype": str(dtype)[6:], "bh": 6,
               "n": n, "max_abs_err": max(errs)}
        emit(rec)
        check(ok, f"flash backward at a TP head group {rec}")
    n_local, bounds = sp_shapes(n240, 2)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = head_inputs(2, 3, n_local, dtype, seed=n_local)
        g = torch.Generator(device="cuda").manual_seed(n_local + 1)
        do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
        for valid in bounds:
            if not valid:
                continue
            out, lse = flash_attention_with_lse_dyn(q, k, v, SCALE, valid)
            ref, ref_lse = attention_dyn_plain(q, k, v, SCALE, valid)
            dsum = (do.float() * ref.float()).sum(-1).reshape(6, n_local)
            got = flash_attention_bwd_dyn(q, do, ref_lse, dsum, k, v, SCALE,
                                          valid)
            torch.cuda.synchronize()
            b_errs, b_ok = bwd_dyn_err(got, attention_bwd_dyn_plain(
                q, do, ref_lse, dsum, k, v, SCALE, valid), dtype)
            err = (out.float() - ref.float()).abs()
            atol, rtol = FLASH_TOL[dtype]
            rec = {"phase": "tp", "part": "kernel_check",
                   "kernel": "flash_attn_fwd_dyn + flash_attn_bwd_dyn",
                   "dtype": str(dtype)[6:], "bh": 6, "n_local": n_local,
                   "valid": valid, "fwd_max_abs_err": err.max().item(),
                   "bwd_max_abs_err": max(b_errs)}
            emit(rec)
            check(bool((err <= atol + rtol * ref.float().abs()).all()),
                  f"dyn forward at the SP x TP hop {rec}")
            check(b_ok, f"dyn backward at the SP x TP hop {rec}")


def tp_predict_checks(rank, world, backend):
    """(a) DINOSeg.predict_batch(parallelism='tp') at the bench config
    (ViT-S/8, 3 blocks, MLP head, 7 classes, 480x640 frames at 480px),
    batch 3 and 1, bf16 and fp32, against the world of one on this card
    (predict_batch without parallelism): fp32 labels equal except top-2
    gaps under MARGIN, bf16 under TP_BF16_MARGIN; every rank the same bits;
    3 forward launches a call of a rank with heads, no fused MLP.  Returns
    the launch counts."""
    model = DINOSeg(head="mlp", n_blocks=3, n_classes=7, precision="bf16",
                    random_init=True, seed=0)
    model.set_resolution(TP_PRED_RES)
    heads = model._tp_params()[0][0]["heads"]
    total = {}
    for prec, margin in (("bf16", TP_BF16_MARGIN), ("fp32", MARGIN)):
        for batch in (3, 1):
            frames = tp_frames(batch)
            want = model.predict_batch(frames, precision=prec)
            logp = model.log_probs(torch.from_numpy(frames).cuda(),
                                   precision=prec).cpu()
            got, launches = counted(lambda: model.predict_batch(
                frames, precision=prec, parallelism="tp"))
            add_counts(total, launches)
            n_diff, n_far = labels_agree(got, want, near_ties(logp, margin),
                                         TP_PRED_RES // 8)
            f32 = 3 * (prec == "fp32") if heads else 0
            expect = dict(sp_want(0), flash_attn_fwd=3 if heads else 0,
                          flash_attn_fwd_f32=f32)
            rec = {"phase": "tp", "part": "a predict vs world of one",
                   "rank": rank, "world": world, "backend": backend,
                   "precision": prec, "batch": batch, "heads": heads,
                   "patches_differing": n_diff, "differing_past_margin":
                   n_far, "margin": margin,
                   "ranks_same_bits": replicas_same(
                       [torch.from_numpy(got)]),
                   "launches": launches, "want": expect}
            emit(rec)
            check(n_far == 0, f"TP labels differ past the margin {rec}")
            check(rec["ranks_same_bits"], f"TP ranks' labels differ {rec}")
            check(launches == expect, f"TP predict launches {rec}")
    return total


def tp_bench_step(rank, world, backend):
    """(c) the bf16 unfrozen step at the train bench's shapes (480px, batch
    16 in 8 microbatches of 2) with the blocks tensor-parallel over the
    ranks (make_train_step(tp_group=...); the data group is one rank):
    one warm-up and DP_STEPS timed steps on the host clock, then one step
    with the model group's all-reduces timed; the whole parameters the
    same bits on every rank after each step.  Returns the launch counts."""
    from dino_tpu_torch.parallel.tp import tp_shard_vit
    group = dist.group.WORLD
    rs = np.random.RandomState(21)
    x = torch.from_numpy(rs.randint(0, 255, (DP_BATCH, FIT_RES, FIT_RES, 3))
                         .astype(np.uint8)).cuda()
    y = torch.from_numpy(rs.randint(0, 7, (DP_BATCH, (FIT_RES // 8) ** 2))
                         .astype(np.int32)).cuda()
    m = sp_model("bf16")
    tvit, head = tp_shard_vit(m.model.dino, group), m.model.clf
    optimizer = make_optimizer("adam", DP_LR)
    opt = init_opt_state(optimizer, tvit, head, False)
    accum = DP_BATCH // DP_MICRO
    step = make_train_step(m.cfg, "mlp", 7, optimizer, False,
                           compute_dtype=torch.bfloat16, accum_steps=accum,
                           tp_group=group)
    whole = [p for n, p in tvit.named_parameters()
             if n.split(".")[-1] not in ("qkv_w", "qkv_b", "proj_w", "fc1_w",
                                         "fc1_b", "fc2_w")]
    whole += list(head.parameters())
    want = launches_want(fwd=3 * accum, bwd=3 * accum)
    total, host, same, losses = {}, [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(1 + DP_STEPS):
        t0 = time.perf_counter()
        (loss, _), got = counted(lambda: step(tvit, head, opt, x, y))
        host.append((time.perf_counter() - t0) * 1e3)
        add_counts(total, got)
        check(got == want, f"TP step launches {got}, want {want}")
        losses.append(loss.item())
        same.append(replicas_same(whole))
    spent = {"tp_all_reduce": 0.0}
    real = pdist.all_reduce_sum_

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(*a, **k)
        torch.cuda.synchronize()
        spent["tp_all_reduce"] += (time.perf_counter() - t0) * 1e3
    pdist.all_reduce_sum_ = timed
    try:
        t0 = time.perf_counter()
        step(tvit, head, opt, x, y)
        torch.cuda.synchronize()
        timed_ms = (time.perf_counter() - t0) * 1e3
    finally:
        pdist.all_reduce_sum_ = real
    rec = {"phase": "tp", "part": "c bf16 TP step at the bench shape",
           "rank": rank, "world": world, "backend": backend,
           "res": FIT_RES, "batch": DP_BATCH, "accum_steps": accum,
           "host_ms_per_step": host, "host_ms": float(np.median(host[1:])),
           "frames_per_s": DP_BATCH / float(np.median(host[1:])) * 1e3,
           "instrumented_step_ms": timed_ms,
           "model_group_all_reduce_ms": spent["tp_all_reduce"],
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "losses": losses, "whole_params_same_bits": same,
           "launches_per_step": want}
    emit(rec)
    check(all(same), f"TP step: the whole parameters part {rec}")
    check(all(np.isfinite(losses)), f"TP step loss {rec}")
    return total


def tp_grads(tvit, head, group):
    """{name: full gradient} of a rank's shard and head, in the standard
    layout (a collective over the model group)."""
    from dino_tpu_torch.parallel.tp import tp_gather_state
    out = {"dino." + k: v for k, v in
           tp_gather_state(tvit, group, grads=True).items()}
    out.update({"clf." + k: p.grad for k, p in head.named_parameters()})
    return out


def tp_f32_steps(rank, world, backend):
    """(b) on the 2 x 2 grid (parallel/mesh.py:make_grid(2)), fp32 at 240px:
    the DP x TP step (global batch 4, 2 a data rank) without and with ZeRO-1
    and the SP x TP step (batch 2) against the world-of-one step from the
    same weights and batch (the head's ReLU choices replayed from it): loss
    rtol STEP_LOSS_RTOL, every gradient leaf within STEP_GRAD_REL of its
    max, ZeRO-1 the plain DP x TP bits; then the bf16 SP x TP step, its
    loss within SP_BF16_LOSS_RTOL of the world of one's.  Returns the
    launch counts."""
    from dino_tpu_torch.parallel.mesh import make_grid
    from dino_tpu_torch.parallel.ring_attention import make_sp_tp_train_step
    from dino_tpu_torch.parallel.tp import tp_gather_state, tp_shard_vit
    dg, mg = make_grid(2)
    d = dist.get_rank(dg)
    out = TP_F32_RES // 8
    rs = np.random.RandomState(24)
    imgs = torch.from_numpy(rs.randint(0, 255, (4, TP_F32_RES, TP_F32_RES,
                                                3)).astype(np.uint8)).cuda()
    labels = torch.from_numpy(rs.randint(0, 7, (4, out * out)).astype(
        np.int32)).cuda()
    total = {}

    def single(cfg, opt, cdt):
        return make_train_step(cfg, "mlp", 7, opt, False, compute_dtype=cdt)

    masks = []
    with head_relu(record=masks):
        ref_m, ref_loss, _ = one_step("fp32", imgs, labels, single)
    ref = {n: p.grad for n, p in ref_m.model.named_parameters()}
    n_rows = 2 * out * out
    local = [mk[d * n_rows:(d + 1) * n_rows] for mk in masks]
    finals = {}
    for mode in ("plain", "zero"):
        m = sp_model("fp32")
        tvit, head = tp_shard_vit(m.model.dino, mg), m.model.clf
        zm = dg if mode == "zero" else None
        optimizer = make_optimizer("adam", 1e-5)
        opt = init_opt_state(optimizer, tvit, head, False, zero_mesh=zm)
        seen = {}
        if mode == "zero":
            shards, real = opt.shards, opt.inner.step

            def gathered_step():
                full = shards._gather_flat([s.grad for s in shards.shards])
                seen.update({id(p): g.view(s) for p, g, s in
                             zip(opt.params, full, shards.shapes)})
                real()
            opt.inner.step = gathered_step
        step = make_train_step(m.cfg, "mlp", 7, optimizer, False,
                               dp_group=dg, tp_group=mg, zero_mesh=zm)
        with head_relu(replay=local) as flips:
            (loss, _), got = counted(lambda: step(
                tvit, head, opt, imgs[2 * d:2 * d + 2],
                labels[2 * d:2 * d + 2]))
        add_counts(total, got)
        if mode == "zero":
            for p in list(tvit.parameters()) + list(head.parameters()):
                p.grad = seen[id(p)]
        worst, leaf = grads_vs(tp_grads(tvit, head, mg), ref)
        finals[mode] = tp_gather_state(tvit, mg)
        want = launches_want(fwd_f32=3, bwd_f32=3)
        rec = {"phase": "tp", "part": "b fp32 DP x TP vs world of one",
               "mode": mode, "rank": rank, "world": world,
               "backend": backend, "res": TP_F32_RES, "global_batch": 4,
               "grid": [2, 2], "loss": loss.item(),
               "loss_world_of_one": ref_loss.item(),
               "grad_worst_rel_diff": worst, "grad_worst_leaf": leaf,
               "grad_tol": STEP_GRAD_REL, "head_relu_units_replayed": flips,
               "launches": got, "want": want}
        if mode == "zero":
            rec["moment_shard_elems_vs_slice"] = [
                [int(opt.inner.state[sh]["exp_avg"].numel()), n]
                for sh, n in zip(opt.shards.shards, opt.shards.numels)][:4]
            rec["state_bytes"] = opt.resident_bytes()
        emit(rec)
        check(got == want, f"DP x TP fp32 launches {rec}")
        check(abs(loss.item() - ref_loss.item())
              <= STEP_LOSS_RTOL * abs(ref_loss.item()),
              f"DP x TP fp32 loss {rec}")
        check(worst <= STEP_GRAD_REL, f"DP x TP fp32 gradients {rec}")
        del m, tvit, head, opt, step
    diff = max((finals["zero"][k] - v).abs().max().item()
               for k, v in finals["plain"].items())
    emit({"phase": "tp", "part": "b ZeRO-1 vs plain DP x TP", "rank": rank,
          "max_abs_diff": diff})
    check(diff == 0.0, f"DP x TP ZeRO-1 parts from plain: {diff}")

    # SP x TP, batch 2: the world-of-one step on the first two frames
    imgs2, labels2 = imgs[:2], labels[:2]
    for prec in ("fp32", "bf16"):
        masks = [] if prec == "fp32" else None
        with (head_relu(record=masks) if masks is not None
              else contextlib.nullcontext()):
            ref_m, ref_loss, _ = one_step(prec, imgs2, labels2, single)
        ref = {n: p.grad for n, p in ref_m.model.named_parameters()}
        with (head_relu(replay=masks, rows=(2, out * out, 2, d))
              if masks is not None else contextlib.nullcontext()) as flips:
            (sp_m, loss, _), got = counted(lambda: one_step(
                prec, imgs2, labels2, lambda cfg, opt, cdt:
                make_sp_tp_train_step(cfg, "mlp", 7, opt, dg, mg,
                                      compute_dtype=cdt)))
        add_counts(total, got)
        worst, leaf = grads_vs({n: p.grad for n, p in
                                sp_m.model.named_parameters()}, ref)
        want = (sp_want(3 * 2, bwd_f32=3 * 2) if prec == "fp32"
                else sp_want(3 * 2, bwd_dyn=3 * 2))
        rec = {"phase": "tp", "part": "b SP x TP vs world of one",
               "precision": prec, "rank": rank, "world": world,
               "backend": backend, "res": TP_F32_RES, "batch": 2,
               "grid": [2, 2], "loss": loss.item(),
               "loss_world_of_one": ref_loss.item(),
               "grad_worst_rel_diff": worst, "grad_worst_leaf": leaf,
               "head_relu_units_replayed": flips, "launches": got,
               "want": want}
        emit(rec)
        check(got == want, f"SP x TP launches {rec}")
        check(bool(torch.isfinite(loss)), f"SP x TP loss {rec}")
        if prec == "fp32":
            check(abs(loss.item() - ref_loss.item())
                  <= STEP_LOSS_RTOL * abs(ref_loss.item()),
                  f"SP x TP fp32 loss {rec}")
            check(worst <= STEP_GRAD_REL, f"SP x TP fp32 gradients {rec}")
        else:
            check(abs(loss.item() - ref_loss.item())
                  <= SP_BF16_LOSS_RTOL * abs(ref_loss.item()),
                  f"SP x TP bf16 loss {rec}")
        del ref_m, sp_m
    return total


def predict_latency(model, batch, parallelism=None, precision="bf16"):
    """Host ms of DINOSeg.predict_device at the bench config (frames already
    on the card, labels left there, the card synchronized after each
    call): the median of TP_LAT_CALLS calls after 3 untimed ones, and the
    readings.  Every rank of a TP world calls it in step."""
    imgs = torch.from_numpy(tp_frames(batch)).cuda()
    for _ in range(3):
        model.predict_device(imgs, precision, parallelism)
    torch.cuda.synchronize()
    times = []
    for _ in range(TP_LAT_CALLS):
        t0 = time.perf_counter()
        model.predict_device(imgs, precision, parallelism)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times


def tp_latency(rank, world, backend):
    """--tp-world: TP predict latency at batch 1 and 3 (bf16, the bench
    config), beside one all-reduce of a block's (B, 3,601, 384) float32
    partial (a predict makes two a block, six in all), the rank's peak
    memory over the calls, and its weight bytes (its blocks' slices and
    the whole embeddings, norms and head) against the whole model's."""
    model = DINOSeg(head="mlp", n_blocks=3, n_classes=7, precision="bf16",
                    random_init=True, seed=0)
    model.set_resolution(TP_PRED_RES)
    blocks, head, _ = model._tp_params()
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    sliced = nbytes([v for b in blocks for v in b.values()
                     if torch.is_tensor(v)])
    whole_vit = nbytes(list(model.model.dino.parameters()))
    blocks_whole = nbytes(list(model.model.dino.blocks.parameters()))
    rank_bytes = sliced + whole_vit - blocks_whole + nbytes(
        list(head.parameters()))
    n = (TP_PRED_RES // 8) ** 2 + 1
    for batch in (1, 3):
        torch.cuda.reset_peak_memory_stats()
        ms, times = predict_latency(model, batch, "tp")
        peak = torch.cuda.max_memory_allocated()
        part = torch.zeros(batch, n, 384, device="cuda")
        ar = []
        for _ in range(TP_LAT_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pdist.all_reduce_sum_([part])
            torch.cuda.synchronize()
            ar.append((time.perf_counter() - t0) * 1e3)
        emit({"phase": "tp", "part": "tp-world predict latency",
              "rank": rank, "world": world, "backend": backend,
              "batch": batch, "res": TP_PRED_RES, "precision": "bf16",
              "host_ms": ms, "host_ms_per_call": times,
              "all_reduce_ms": float(np.median(ar)),
              "all_reduces_per_predict": 6, "peak_bytes": peak,
              "rank_weight_bytes": rank_bytes,
              "whole_model_bytes": whole_vit + nbytes(
                  list(model.model.clf.parameters()))})


def tp_rank_main(rank, world, store, backend):
    """One rank of phase 14 (gloo, ranks sharing the card: a world of 2
    runs (a) and (c), a world of 4 (b)) or of --tp-world (NCCL, one card a
    rank: (a) and the latency readings, and (b) in a world of 4).  Prints
    JSON records, the last one its summary."""
    pdist.init_distributed_mode(backend, f"file://{store}", world, rank)
    total = {}
    if backend == "gloo" and world == 2:
        add_counts(total, tp_predict_checks(rank, world, backend))
        add_counts(total, tp_bench_step(rank, world, backend))
    elif backend == "gloo":
        add_counts(total, tp_f32_steps(rank, world, backend))
    else:
        add_counts(total, tp_predict_checks(rank, world, backend))
        tp_latency(rank, world, backend)
        if world == 4:
            add_counts(total, tp_f32_steps(rank, world, backend))
    dist.destroy_process_group()
    emit({"tp_rank_ok": True, "rank": rank, "launches": total})


def phase_tp(bare_fps):
    """Phase 14: the kernels at the TP paths' new shapes, then rank
    processes sharing the card over gloo: a world of 2 ((a) TP predict,
    (c) the bf16 TP step) and a world of 4 ((b) the fp32 DP x TP and SP x
    TP steps on the 2 x 2 grid).  Returns the ranks' summed launch
    counts."""
    t0 = time.perf_counter()
    tp_kernel_checks()
    torch.cuda.empty_cache()
    total, fps = {}, []
    for world in (2, 4):
        summaries, records = join_ranks(start_ranks("tp", world, "gloo"),
                                        "tp", TP_RANK_TIMEOUT)
        for s in summaries:
            add_counts(total, s["launches"])
        fps += [r["frames_per_s"] for r in records
                if r.get("part", "").startswith("c ")]
    for name in ("flash_attn_fwd", "flash_attn_fwd_f32", "flash_attn_bwd",
                 "flash_attn_bwd_f32", "flash_attn_fwd_dyn",
                 "flash_attn_bwd_dyn"):
        check(total.get(name, 0) > 0, f"phase 14 never launched {name}")
    check(total.get("fused_ln_mlp", 0) == 0,
          "a TP path launched the fused MLP")
    emit({"phase": "tp", "rank_launches_summed": total,
          "c_frames_per_s_per_rank": fps,
          "world_of_one_bare_step_frames_per_s_phase5": bare_fps,
          "seconds": time.perf_counter() - t0})
    return total


def tp_cards_main(world, card):
    """--tp-world: TP predict over NCCL with one rank a card, in worlds of 2
    and ``world`` (4 splits the 6 heads 2, 2, 1, 1), against the world of
    one on card 0 in the same call; with 4 cards also (b)'s steps on the
    2 x 2 grid."""
    check(torch.cuda.device_count() >= world,
          f"--tp-world {world} needs {world} cards, found "
          f"{torch.cuda.device_count()}")
    emit({"phase": "device", "names": [torch.cuda.get_device_name(i)
                                       for i in range(world)],
          "nvidia_smi": card, "torch": torch.__version__})
    _build.library()
    model = DINOSeg(head="mlp", n_blocks=3, n_classes=7, precision="bf16",
                    random_init=True, seed=0)
    model.set_resolution(TP_PRED_RES)
    for batch in (1, 3):
        ms, times = predict_latency(model, batch)
        emit({"phase": "tp", "part": "tp-world predict latency", "world": 1,
              "batch": batch, "res": TP_PRED_RES, "precision": "bf16",
              "host_ms": ms, "host_ms_per_call": times})
    del model
    torch.cuda.empty_cache()
    total = {}
    for t in sorted({2, world}):
        summaries, _ = join_ranks(start_ranks("tp", t, "nccl"), "tp",
                                  TP_RANK_TIMEOUT)
        for s in summaries:
            add_counts(total, s["launches"])
    emit({"phase": "tp", "world": world, "backend": "nccl",
          "rank_launches_summed": total})
    check(total.get("flash_attn_fwd", 0) > 0, "a TP rank launched no forward")
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


# ---------------------------------------------------------------------------
# Phase 15: pipeline parallelism (the 1F1B, interleaved 1F1B and GPipe
# steps, PP x TP, fit(parallelism='pp'))
# ---------------------------------------------------------------------------

PP_DEPTH = 12          # the whole ViT-S/8 backbone
PP_RANK_TIMEOUT = 600  # seconds for a world of rank processes, from its start
PP_F32_RES, PP_F32_BATCH, PP_F32_MB = 240, 2, 2   # (a) and (d)
PP_MB = 8              # (b): the bench batch (DP_BATCH at FIT_RES) in 8
# (b): the bf16 1F1B loss against the plain bf16 step's (dino_tpu's bound,
# tests/test_pipeline.py:404), and the bf16 pipelined forward against the
# world of one's, max |err| against max |ref| (cuBLAS may round the
# microbatch's products another way than the batch's)
PP_BF16_LOSS_TOL = 2e-2
PP_FWD_REL = 2e-2
# (b): the first bf16 1F1B step's gradients (the bf16 stash, both hops and
# the pending cotangent) against the world of one's bf16 step on the same
# 8 microbatches, each leaf's max |diff| against its max |g| (bf16 keeps 8
# bits; the backward kernel's own bf16 bound, BWD_BF16_REL)
PP_BF16_GRAD_REL = 2e-2
PP_FIT_SAMPLES = 3     # (c): 2 steps of batch 2, the second a ragged tail


def pp_model(prec):
    """Phase 15's model: random ViT-S/8 weights from seed 5, all 12 blocks,
    MLP head, 7 classes, backbone trainable."""
    return DINOSeg(head="mlp", n_blocks=PP_DEPTH, n_classes=7,
                   precision=prec, random_init=True, seed=5,
                   freeze_backbone=False)


def pp_batch(batch, res, seed):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 255, (batch, res, res, 3)).astype(np.uint8)
    y = rs.randint(0, 7, (batch, (res // 8) ** 2)).astype(np.int32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def pp_chunks(world):
    """V of --pp-world's interleaved step: chunks that divide the depth."""
    return next(v for v in (2, 3) if PP_DEPTH % (world * v) == 0)


def pp_kernel_checks():
    """The kernels at the PP paths' shapes that earlier phases do not
    cover, against their plain versions: the fused MLP at the bf16
    pipelined forward's microbatch (2 x 3,601 rows), and the f32 forward
    and backward at the PP x TP stage's head group of (d) (1 x 3 heads, N
    901)."""
    from dino_tpu_torch.models.vit import Block
    g = torch.Generator().manual_seed(15)
    block = Block(ViTConfig())
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    block = block.cuda()
    check_mlp(block.norm2, block.mlp, 2 * ((FIT_RES // 8) ** 2 + 1),
              torch.Generator(device="cuda").manual_seed(15))
    n = (PP_F32_RES // 8) ** 2 + 1
    atol, rtol = FLASH_TOL[torch.float32]
    q, k, v = head_inputs(1, 3, n, torch.float32, seed=n + 15)
    do = torch.randn(q.shape, generator=torch.Generator(
        device="cuda").manual_seed(n), device="cuda")
    out, lse = flash_attention(q, k, v, SCALE, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, do, SCALE)
    torch.cuda.synchronize()
    ref, ref_lse = attention_plain(q, k, v, SCALE)
    err = (out - ref).abs()
    errs, ok = bwd_err(got, attention_bwd_plain(q, k, v, out, lse, do,
                                                SCALE), torch.float32)
    rec = {"phase": "pp", "part": "kernel_check",
           "kernel": "flash_attn_fwd + flash_attn_bwd", "dtype": "float32",
           "bh": 3, "n": n, "fwd_max_abs_err": err.max().item(),
           "lse_max_abs_err": (lse - ref_lse).abs().max().item(),
           "bwd_max_abs_err": max(errs)}
    emit(rec)
    check(bool((err <= atol + rtol * ref.abs()).all())
          and rec["lse_max_abs_err"] <= LSE_ATOL,
          f"f32 forward at the PP x TP head group {rec}")
    check(ok, f"f32 backward at the PP x TP head group {rec}")


@contextlib.contextmanager
def hop_timer():
    """Milliseconds spent in the pipeline's stage hops (host clock, the card
    synchronized around each), and their count."""
    from dino_tpu_torch.parallel import pipeline as pp_mod
    real, spent = pp_mod.stage_hop, {"hop_ms": 0.0, "hops": 0}

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        spent["hop_ms"] += (time.perf_counter() - t0) * 1e3
        spent["hops"] += 1
        return out
    pp_mod.stage_hop = timed
    try:
        yield spent
    finally:
        pp_mod.stage_hop = real


def pp_grads(svit, vit, head, group):
    """{name: gradient} of a stage's rank in the standard layout (the
    stages' gather, a collective) and of the head."""
    from dino_tpu_torch.parallel.pipeline import pp_gather_state
    out = {"dino." + k: v for k, v in
           pp_gather_state(svit, vit, group, grads=True).items()}
    out.update({"clf." + k: p.grad for k, p in head.named_parameters()})
    return out


def pp_plain_step(prec, imgs, labels, record=None, accum_steps=1):
    """One Adam 1e-5 step of make_train_step on a fresh pp_model (over
    ``accum_steps`` microbatches): (the model with its gradients, loss,
    launches), the head's ReLU masks in ``record`` (head_relu) when
    given."""
    m = pp_model(prec)
    vit, head = m.model.dino, m.model.clf
    opt = make_optimizer("adam", DP_LR)
    step = make_train_step(m.cfg, "mlp", 7, opt, False,
                           compute_dtype=torch.bfloat16 if prec == "bf16"
                           else None, accum_steps=accum_steps)
    state = init_opt_state(opt, vit, head, False)
    with (head_relu(record=record) if record is not None
          else contextlib.nullcontext()):
        (loss, _), got = counted(lambda: step(vit, head, state, imgs,
                                              labels))
    return m, loss, got


def pp_f32_steps(rank, world, backend):
    """(a) fp32 at 240px, batch 2 in 2 microbatches: the 1F1B, interleaved
    1F1B (V = 2) and GPipe steps against the world-of-one step on this card
    from the same weights and batch (the head's ReLU choices replayed from
    it, cut to the rows each rank's head scores): loss rtol
    STEP_LOSS_RTOL, every gradient leaf within STEP_GRAD_REL of its max,
    the launches the schedule's.  Returns the launch counts."""
    from dino_tpu_torch.parallel import pipeline as pp_mod
    group = dist.group.WORLD
    x, y = pp_batch(PP_F32_BATCH, PP_F32_RES, 31)
    masks = []
    ref_m, ref_loss, got = pp_plain_step("fp32", x, y, record=masks)
    total = dict(got)
    ref = {n: p.grad for n, p in ref_m.model.named_parameters()}
    rows = y.numel()
    mb_rows = rows // PP_F32_MB
    last = rank == world - 1
    per = PP_DEPTH // world
    lo, hi = pp_mod._chunk_rows(rows, world, rank)
    runs = (("1f1b", 1, pp_mod.make_pp_1f1b_train_step, {}),
            ("interleaved_1f1b", 2,
             pp_mod.make_pp_interleaved_1f1b_train_step, {"n_chunks": 2}),
            ("gpipe", 1, pp_mod.make_pp_train_step, {}))
    for name, chunks, make, kw in runs:
        m = pp_model("fp32")
        vit, head = m.model.dino, m.model.clf
        svit = pp_mod.pp_shard_vit(vit, group, chunks)
        opt = make_optimizer("adam", DP_LR)
        state = init_opt_state(opt, svit, head, False)
        step = make(m.cfg, "mlp", 7, opt, group, n_microbatches=PP_F32_MB,
                    **kw)
        if name == "gpipe":  # each rank scores its chunk of the rows
            cuts = [slice(lo, hi)]
        else:  # the last stage scores each microbatch in turn
            cuts = [slice(i * mb_rows, (i + 1) * mb_rows)
                    for i in range(PP_F32_MB)] if last else []
        replay = [mk[c] for c in cuts for mk in masks]
        with head_relu(replay=replay) as flips:
            res, got = counted(lambda: step(svit, head, state, x, y))
        add_counts(total, got)
        loss = res[0] if isinstance(res, tuple) else res
        worst, leaf = grads_vs(pp_grads(svit, vit, head, group), ref)
        slots = 1 if name == "gpipe" else 2  # 1F1B: slot + recompute
        want = launches_want(fwd_f32=slots * PP_F32_MB * per,
                             bwd_f32=PP_F32_MB * per)
        rec = {"phase": "pp", "part": "a fp32 step vs world of one",
               "schedule": name, "chunks": chunks, "rank": rank,
               "world": world, "backend": backend, "res": PP_F32_RES,
               "batch": PP_F32_BATCH, "microbatches": PP_F32_MB,
               "blocks": PP_DEPTH, "loss": loss.item(),
               "loss_world_of_one": ref_loss.item(),
               "grad_worst_rel_diff": worst, "grad_worst_leaf": leaf,
               "grad_tol": STEP_GRAD_REL, "head_relu_units_replayed": flips,
               "stage_blocks": svit.block_ids, "launches": got,
               "want": want}
        emit(rec)
        check(got == want, f"PP fp32 launches {rec}")
        check(abs(loss.item() - ref_loss.item())
              <= STEP_LOSS_RTOL * abs(ref_loss.item()),
              f"PP fp32 loss {rec}")
        check(worst <= STEP_GRAD_REL, f"PP fp32 gradients {rec}")
        del m, vit, head, svit, state, step
    del ref_m, ref
    torch.cuda.empty_cache()
    return total


def pp_bench_steps(rank, world, backend, schedules):
    """(b) the bf16 bench step (480px, batch 16 in PP_MB microbatches of 2)
    with the 12 blocks over the ranks, for each (schedule, V): first the
    bf16 pipelined forward of the batch against vit_forward on this card
    (PP_MB * per forward and fused-MLP launches a rank), then one warm-up
    and DP_STEPS timed steps on the host clock (each rank's launches the
    schedule's; the warm-up's loss and every gradient leaf against the
    world of one's bf16 step on the same microbatches, run here first),
    one step with its hops timed, each rank's resident bytes of blocks and
    moments against the whole model's, and the peak.  Returns the launch
    counts."""
    from dino_tpu_torch.models.vit import vit_forward
    from dino_tpu_torch.parallel import pipeline as pp_mod
    from dino_tpu_torch.ops.preprocess import normalize_imagenet
    group = dist.group.WORLD
    x, y = pp_batch(DP_BATCH, FIT_RES, 21)
    per = PP_DEPTH // world
    ref_m, ref_loss, total = pp_plain_step("bf16", x, y, accum_steps=PP_MB)
    ref = {n: p.grad.cpu() for n, p in ref_m.model.named_parameters()}
    ref_loss = ref_loss.item()
    del ref_m
    torch.cuda.empty_cache()
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    for schedule, chunks in schedules:
        m = pp_model("bf16")
        vit, head = m.model.dino, m.model.clf
        whole = 3 * nbytes(list(vit.blocks.parameters()))  # + 2 moments
        svit = pp_mod.pp_shard_vit(vit, group, chunks)
        fwd = {}
        if chunks == 1:
            with torch.no_grad(), matmul_ctx(torch.bfloat16):
                xn = normalize_imagenet(x).to(torch.bfloat16)
                want_tok = vit_forward(vit, xn, m.cfg)
                tok, got = counted(lambda: pp_mod.vit_forward_pipelined(
                    svit, xn, m.cfg, group, n_microbatches=PP_MB))
            add_counts(total, got)
            err = (tok.float() - want_tok.float()).abs().max().item()
            fwd = {"fwd_max_abs_err": err,
                   "fwd_max_abs_ref": want_tok.float().abs().max().item(),
                   "fwd_launches": got,
                   "fwd_want": launches_want(fwd=PP_MB * per,
                                             mlp=PP_MB * per)}
            check(got == fwd["fwd_want"], f"PP forward launches {fwd}")
            check(err <= PP_FWD_REL * fwd["fwd_max_abs_ref"],
                  f"PP bf16 forward vs the world of one {fwd}")
            del tok, want_tok, xn
        vit.blocks.to("cpu")  # the rank holds only its stage, as fit does
        torch.cuda.empty_cache()
        optimizer = make_optimizer("adam", DP_LR)
        opt = init_opt_state(optimizer, svit, head, False)
        make = (pp_mod.make_pp_1f1b_train_step if chunks == 1 else
                functools.partial(pp_mod.make_pp_interleaved_1f1b_train_step,
                                  n_chunks=chunks))
        step = make(m.cfg, "mlp", 7, optimizer, group, n_microbatches=PP_MB,
                    compute_dtype=torch.bfloat16)
        want = launches_want(fwd=2 * PP_MB * per, bwd=PP_MB * per)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        host, losses = [], []
        for i in range(1 + DP_STEPS):
            t0 = time.perf_counter()
            (loss, _), got = counted(lambda: step(svit, head, opt, x, y))
            host.append((time.perf_counter() - t0) * 1e3)
            add_counts(total, got)
            check(got == want, f"PP {schedule} launches {got}, want {want}")
            losses.append(loss.item())
            if i == 0:  # the gradients of the weights the world of one had
                worst, leaf = grads_vs({k: g.cpu() for k, g in pp_grads(
                    svit, vit, head, group).items()}, ref)
        peak = torch.cuda.max_memory_allocated()
        with hop_timer() as hops:
            t0 = time.perf_counter()
            _, got = counted(lambda: step(svit, head, opt, x, y))
            instrumented = (time.perf_counter() - t0) * 1e3
        add_counts(total, got)
        blocks = list(svit.blocks.parameters())
        rank_bytes = nbytes(blocks) + nbytes(
            [v for p in blocks for v in opt.state[p].values()
             if torch.is_tensor(v) and v.dim() > 0])
        rec = {"phase": "pp", "part": "b bf16 step at the bench shape",
               "schedule": schedule, "chunks": chunks, "rank": rank,
               "world": world, "backend": backend, "res": FIT_RES,
               "batch": DP_BATCH, "microbatches": PP_MB,
               "blocks": PP_DEPTH, "stage_blocks": svit.block_ids,
               "host_ms_per_step": host,
               "host_ms": float(np.median(host[1:])),
               "frames_per_s": DP_BATCH / float(np.median(host[1:])) * 1e3,
               "instrumented_step_ms": instrumented, **hops,
               "peak_bytes": peak, "rank_block_and_moment_bytes": rank_bytes,
               "whole_block_and_moment_bytes": whole,
               "bound_bytes": whole / world + whole / PP_DEPTH,
               "losses": losses, "loss_first_world_of_one": ref_loss,
               "grad_worst_rel_diff": worst, "grad_worst_leaf": leaf,
               "grad_tol": PP_BF16_GRAD_REL, "launches_per_step": want,
               **fwd}
        emit(rec)
        check(worst <= PP_BF16_GRAD_REL, f"PP bf16 gradients {rec}")
        check(abs(losses[0] - ref_loss) <= PP_BF16_LOSS_TOL
              * (1 + abs(ref_loss)), f"PP bf16 first loss {rec}")
        check(rank_bytes <= rec["bound_bytes"],
              f"PP rank holds more than its stage {rec}")
        check(all(np.isfinite(losses)), f"PP {schedule} loss {rec}")
        del m, vit, head, svit, opt, step
        torch.cuda.empty_cache()
    return total


def pp_fit_kw():
    return dict(precision="fp32", freeze_backbone=False,
                batch_size=PARITY_BATCH, lr=PARITY_LR, augmented=False,
                train_resolution=PARITY_RES, n_blocks=PP_DEPTH, max_epochs=1)


def pp_fit(rank, world, tmp):
    """(c) one fp32 fit(parallelism='pp') epoch on phase 9's bands at 240px
    (batch 2 in 2 microbatches, 3 samples: a ragged tail), every rank;
    rank 0 records the logged train metrics.  Returns the launch
    counts."""
    splits = {name: memory_split(n, seed) for seed, (name, n) in
              enumerate(FIT_FRAMES.items())}
    model = fit_model(splits, os.path.join(tmp, "pp_fit"), **pp_fit_kw())
    test, got = counted(lambda: model.fit(
        samples_per_epoch=PP_FIT_SAMPLES, parallelism="pp",
        pp_microbatches=PARITY_BATCH))
    per = PP_DEPTH // world
    steps = batches(PP_FIT_SAMPLES, PARITY_BATCH)
    evals = sum(batches(len(range(rank, FIT_FRAMES[s], world)),
                        PARITY_BATCH) for s in ("val", "test"))
    want = launches_want(fwd_f32=steps * 2 * PARITY_BATCH * per
                         + evals * PP_DEPTH,
                         bwd_f32=steps * PARITY_BATCH * per)
    metrics = epoch_metrics(model)
    rec = {"phase": "pp", "part": "c fit", "rank": rank, "world": world,
           "res": PARITY_RES, "samples_per_epoch": PP_FIT_SAMPLES,
           "train": metrics[0][1] if metrics else None, "test": test,
           "launches": got, "want": want}
    emit(rec)
    check(got == want, f"PP fit launches {rec}")
    return got


def pp_tp_step(rank, world, backend):
    """(d) DP x PP x TP on 4 ranks sharing the card (data 1 x stage 2 x
    model 2, parallel/mesh.py:make_grid(2, stage=2)), fp32 at 240px, batch
    2 in 2 microbatches: the step against the world-of-one step (ReLU
    choices replayed on each rank's rows), loss and every gradient leaf
    as (a).  Returns the launch counts."""
    from dino_tpu_torch.parallel import pipeline as pp_mod
    from dino_tpu_torch.parallel.mesh import make_grid
    dg, sg, mg = make_grid(2, stage=2)
    s = dist.get_rank(sg)
    x, y = pp_batch(PP_F32_BATCH, PP_F32_RES, 31)
    masks = []
    ref_m, ref_loss, total = pp_plain_step("fp32", x, y, record=masks)
    ref = {n: p.grad for n, p in ref_m.model.named_parameters()}
    lo, hi = pp_mod._chunk_rows(y.numel(), 2, s)
    m = pp_model("fp32")
    vit, head = m.model.dino, m.model.clf
    opt = make_optimizer("adam", DP_LR)
    step = pp_mod.make_dp_pp_tp_train_step(m.cfg, "mlp", 7, opt, dg, sg, mg,
                                           n_microbatches=PP_F32_MB)
    with head_relu(replay=[mk[lo:hi] for mk in masks]) as flips:
        (loss, _), got = counted(lambda: step(
            vit, head, init_opt_state(opt, vit, head, False), x, y))
    add_counts(total, got)
    worst, leaf = grads_vs({n: p.grad for n, p in
                            m.model.named_parameters()}, ref)
    per = PP_DEPTH // 2
    want = launches_want(fwd_f32=PP_F32_MB * per, bwd_f32=PP_F32_MB * per)
    rec = {"phase": "pp", "part": "d fp32 DP x PP x TP vs world of one",
           "rank": rank, "world": world, "backend": backend,
           "grid": [1, 2, 2], "res": PP_F32_RES, "batch": PP_F32_BATCH,
           "loss": loss.item(), "loss_world_of_one": ref_loss.item(),
           "grad_worst_rel_diff": worst, "grad_worst_leaf": leaf,
           "head_relu_units_replayed": flips, "launches": got,
           "want": want}
    emit(rec)
    check(got == want, f"PP x TP launches {rec}")
    check(abs(loss.item() - ref_loss.item())
          <= STEP_LOSS_RTOL * abs(ref_loss.item()), f"PP x TP loss {rec}")
    check(worst <= STEP_GRAD_REL, f"PP x TP gradients {rec}")
    return total


def pp_rank_main(rank, world, store, backend):
    """One rank of phase 15 (gloo, ranks sharing the card: a world of 2
    runs (a), (b) and (c), a world of 4 (d)) or of --pp-world (NCCL, one
    card a rank: (b) with both 1F1B schedules).  Prints JSON records, the
    last one its summary."""
    pdist.init_distributed_mode(backend, f"file://{store}", world, rank)
    total = {}
    if backend == "gloo" and world == 2:
        add_counts(total, pp_f32_steps(rank, world, backend))
        add_counts(total, pp_bench_steps(rank, world, backend,
                                         (("1f1b", 1),)))
        add_counts(total, pp_fit(rank, world, os.path.dirname(store)))
    elif backend == "gloo":
        add_counts(total, pp_tp_step(rank, world, backend))
    else:
        add_counts(total, pp_bench_steps(
            rank, world, backend,
            (("1f1b", 1), ("interleaved_1f1b", pp_chunks(world)))))
    dist.destroy_process_group()
    emit({"pp_rank_ok": True, "rank": rank, "launches": total})


def pp_world_of_one():
    """The plain 12-block bf16 step at (b)'s bench shape on this card (one
    warm-up and DP_STEPS timed steps): its record, and its launch
    counts."""
    x, y = pp_batch(DP_BATCH, FIT_RES, 21)
    torch.cuda.reset_peak_memory_stats()
    m = pp_model("bf16")
    vit, head = m.model.dino, m.model.clf
    opt = make_optimizer("adam", DP_LR)
    state = init_opt_state(opt, vit, head, False)
    step = make_train_step(m.cfg, "mlp", 7, opt, False, accum_steps=PP_MB,
                           compute_dtype=torch.bfloat16)
    total, host, losses = {}, [], []
    for _ in range(1 + DP_STEPS):
        t0 = time.perf_counter()
        (loss, _), got = counted(lambda: step(vit, head, state, x, y))
        host.append((time.perf_counter() - t0) * 1e3)
        add_counts(total, got)
        losses.append(loss.item())
    rec = {"phase": "pp", "part": "b world of one, 12 blocks",
           "res": FIT_RES, "batch": DP_BATCH, "accum_steps": PP_MB,
           "host_ms_per_step": host, "host_ms": float(np.median(host[1:])),
           "frames_per_s": DP_BATCH / float(np.median(host[1:])) * 1e3,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "losses": losses}
    emit(rec)
    del m, vit, head, state, step
    torch.cuda.empty_cache()
    return rec, total


def pp_check_losses(plain, records):
    """(b)'s 1F1B losses on every rank against the plain step's, step by
    step (the same weights, batch and updates): after the first step each
    loss reads the update the step before made."""
    for rec in records:
        if rec.get("part", "").startswith("b bf16"):
            a, b = rec["losses"], plain["losses"]
            ok = len(a) == len(b) and all(
                abs(u - v) <= PP_BF16_LOSS_TOL * (1 + abs(v))
                for u, v in zip(a, b))
            emit({"phase": "pp", "part": "b loss vs world of one",
                  "rank": rec["rank"], "schedule": rec["schedule"],
                  "losses": a, "losses_world_of_one": b, "within": ok})
            check(ok, f"PP bf16 losses {a} vs the world of one's {b}")


def pp_check_fit(records, tmp):
    """(c): the plain fit on the same batches, here, against rank 0's
    logged train metrics (atol 1e-6, the loss FIT_LOSS_RTOL).  Returns its
    launch counts."""
    splits = {name: memory_split(n, seed) for seed, (name, n) in
              enumerate(FIT_FRAMES.items())}
    one = fit_model(splits, os.path.join(tmp, "fit_one"), **pp_fit_kw())
    test, got = counted(lambda: one.fit(samples_per_epoch=PP_FIT_SAMPLES))
    want = epoch_metrics(one)[0][1]
    ranks = [r for r in records if r.get("part") == "c fit" and r["train"]]
    keys = ("train_acc", "train_F1", "train_iou", "train_support")
    check(len(ranks) == 1, "the PP fit logs on rank 0 alone")
    rec = {"phase": "pp", "part": "c fit vs world of one",
           "train_pp": {k: ranks[0]["train"][k] for k in keys
                        + ("train_loss",)},
           "train_world_of_one": {k: want[k] for k in keys
                                  + ("train_loss",)},
           "test_pp": ranks[0]["test"], "test_world_of_one": test}
    emit(rec)
    check(all(abs(rec["train_pp"][k] - want[k]) <= 1e-6 for k in keys),
          f"PP fit train metrics differ from the plain fit's {rec}")
    check(abs(rec["train_pp"]["train_loss"] - want["train_loss"])
          <= FIT_LOSS_RTOL * abs(want["train_loss"]),
          f"PP fit train loss differs from the plain fit's {rec}")
    return got


def phase_pp():
    """Phase 15: the kernels at the PP paths' new shapes, the world of
    one's 12-block bf16 step, then rank processes sharing the card over
    gloo: a world of 2 ((a) the fp32 steps, (b) the bf16 1F1B step, (c) a
    fit epoch, held to the world of one's fit here) and a world of 4 ((d)
    DP x PP x TP).  Returns the summed launch counts."""
    t0 = time.perf_counter()
    pp_kernel_checks()
    plain, total = pp_world_of_one()
    started = start_ranks("pp", 2, "gloo")
    summaries, records = join_ranks(started, "pp", PP_RANK_TIMEOUT)
    for s in summaries:
        add_counts(total, s["launches"])
    pp_check_losses(plain, records)
    add_counts(total, pp_check_fit(records, os.path.dirname(started[2])))
    shutil.rmtree(os.path.dirname(started[2]), ignore_errors=True)
    summaries, _ = join_ranks(start_ranks("pp", 4, "gloo"), "pp",
                              PP_RANK_TIMEOUT)
    for s in summaries:
        add_counts(total, s["launches"])
    for name in ("flash_attn_fwd", "flash_attn_fwd_f32", "fused_ln_mlp",
                 "flash_attn_bwd", "flash_attn_bwd_f32"):
        check(total.get(name, 0) > 0, f"phase 15 never launched {name}")
    emit({"phase": "pp", "launches_summed": total,
          "seconds": time.perf_counter() - t0})
    return total


def pp_cards_main(world, card):
    """--pp-world: (b) over NCCL with one rank a card (S = world, the 1F1B
    and interleaved 1F1B steps), beside the world of one's 12-block step
    on card 0 in the same call."""
    check(torch.cuda.device_count() >= world,
          f"--pp-world {world} needs {world} cards, found "
          f"{torch.cuda.device_count()}")
    emit({"phase": "device", "names": [torch.cuda.get_device_name(i)
                                       for i in range(world)],
          "nvidia_smi": card, "torch": torch.__version__})
    _build.library()
    plain, total = pp_world_of_one()
    summaries, records = join_ranks(start_ranks("pp", world, "nccl"), "pp",
                                    PP_RANK_TIMEOUT)
    for s in summaries:
        add_counts(total, s["launches"])
    pp_check_losses(plain, records)
    emit({"phase": "pp", "world": world, "backend": "nccl",
          "launches_summed": total})
    check(total.get("flash_attn_bwd", 0) > 0, "a PP rank launched no "
                                              "backward")
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


CARDS_HW = (480, 640)   # phase 16: the bench's frames
CARDS_DP_RES = 480      # the batch split's resolution: the bench's
CARDS_DP_BATCH = 4      # (a): two chunks of 2 on one card
CARDS_SP_RES = SP_RES   # the SP ring's resolution: 960px, N = 14,401
CARDS_LAT_CALLS = 20    # timed calls per reading
SP_FWD_TOL = dict(atol=2e-5, rtol=1e-5)  # tests/test_torch_port_ring.py:54


def host_ms(fn, calls=CARDS_LAT_CALLS, warmup=3):
    """Host ms of ``fn()`` (which ends in a synchronize or a host copy):
    the median of ``calls`` after ``warmup`` untimed ones, and the
    readings."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times


def cards_frames(batch, seed):
    return np.random.RandomState(seed).randint(
        0, 256, (batch,) + CARDS_HW + (3,)).astype(np.uint8)


def split_labels(model, frames, devices, precision):
    """predict_batch's split over ``devices`` (api.py:_launch_split)."""
    return collect_labels(model._launch_split(torch.from_numpy(frames),
                                              devices, precision))


def one_card_chunks(model, frames, n, precision):
    """The one-card program at batch B/n on each of n chunks, joined."""
    program = predict_program(model, len(frames) // n, CARDS_HW, precision)
    return np.concatenate([program(c) for c in np.split(frames, n)])


def sp_check(model, replicas, frames, precision, tag):
    """The in-process SP ring over ``replicas`` (one SegModel a shard)
    against the one-card forward at the model's resolution: labels equal
    except top-2 gaps under MARGIN, fp32 log-probs within SP_FWD_TOL of the
    one card's.  Returns (the record, the ring's label maps)."""
    res = model.resolution
    imgs = torch.from_numpy(frames).cuda()
    cdt = torch.bfloat16 if precision == "bf16" else None
    with torch.no_grad():
        logp_sp = seg_log_probs_sp(replicas, model.cfg, model.head, imgs,
                                   res, cdt).float().cpu()
    logp = model.log_probs(imgs, precision=precision).float().cpu()
    out_size = res // 8
    got = label_maps(logp_sp, res, model.n_classes).cpu().numpy()
    want = label_maps(logp, res, model.n_classes).cpu().numpy()
    n_diff, n_far = labels_agree(got, want, near_ties(logp), out_size)
    err = float((logp_sp - logp).abs().max())
    rec = {"phase": "cards", "part": tag, "call": "sp ring",
           "shards": len(replicas),
           "devices": [str(next(r.parameters()).device) for r in replicas],
           "res": res, "precision": precision,
           "batch": len(frames), "patches_differing": n_diff,
           "patches_differing_away_from_near_ties": n_far,
           "logp_max_abs_err": err}
    if precision == "fp32":
        rec["logp_within_sp_fwd_tol"] = bool(torch.allclose(
            logp_sp, logp, **SP_FWD_TOL))
        check(n_far == 0 and rec["logp_within_sp_fwd_tol"],
              f"phase 16 SP ring against one card {rec}")
    return rec, got


def trace_names_flash(model, frame, tmp):
    """One bf16 predict under utils/profiling.py:device_trace: the kernel
    names in its Chrome trace that hold 'flash'."""
    model.set_resolution(CARDS_DP_RES)
    with device_trace(os.path.join(tmp, "trace")) as logdir:
        model.predict(frame)
    names = set()
    for path in os.listdir(logdir):
        with open(os.path.join(logdir, path)) as fh:
            for ev in json.load(fh)["traceEvents"]:
                if ev.get("cat") == "kernel" and "flash" in ev.get("name",
                                                                  ""):
                    names.add(ev["name"][:80])
    return sorted(names)


def phase_cards(model, frame):
    """Phase 16 (a) on one card: the batch split and the SP ring with two
    shards on card 0 through their device-list functions, a 2-card
    artifact refused, and device_trace around one predict.  Returns the
    launch counts of the phase."""
    dev = model.device
    total = {}
    tmp = tempfile.mkdtemp(prefix="dtt_cards_")
    try:
        frames = cards_frames(CARDS_DP_BATCH, 16)
        model.set_resolution(CARDS_DP_RES)
        for prec in ("fp32", "bf16"):
            got, c = counted(lambda: split_labels(model, frames, [dev] * 2,
                                                  prec))
            add_counts(total, c)
            want, c = counted(lambda: one_card_chunks(model, frames, 2, prec))
            add_counts(total, c)
            eager, c = counted(lambda: np.concatenate(
                [model.predict_batch(x, prec) for x in np.split(frames, 2)]))
            add_counts(total, c)
            rec = {"phase": "cards", "part": "a", "call": "batch split",
                   "devices": [str(dev)] * 2, "batch": CARDS_DP_BATCH,
                   "precision": prec,
                   "same_bits_as_one_card_program": bool((got == want).all()),
                   "same_bits_as_eager": bool((got == eager).all())}
            for batch in (2, 8):
                fr = cards_frames(batch, 17)
                rec[f"split_host_ms_b{batch}"] = host_ms(
                    lambda: split_labels(model, fr, [dev] * 2, prec))[0]
                rec[f"one_card_host_ms_b{batch}"] = host_ms(
                    lambda: model.predict_batch(fr, prec))[0]
            emit(rec)
            check(rec["same_bits_as_one_card_program"]
                  and rec["same_bits_as_eager"],
                  f"phase 16 batch split against one card {rec}")
        model.set_resolution(CARDS_SP_RES)
        sp_frames = cards_frames(1, 18)
        for prec in ("fp32", "bf16"):
            (rec, _), c = counted(lambda: sp_check(
                model, [model.model] * 2, sp_frames, prec, "a"))
            add_counts(total, c)
            imgs = torch.from_numpy(sp_frames).cuda()
            cdt = torch.bfloat16 if prec == "bf16" else None

            def ring():
                with torch.no_grad():
                    seg_log_probs_sp([model.model] * 2, model.cfg, model.head,
                                     imgs, CARDS_SP_RES, cdt)
                torch.cuda.synchronize()

            def one():
                model.log_probs(imgs, precision=prec)
                torch.cuda.synchronize()
            rec["ring_host_ms"] = host_ms(ring, calls=5, warmup=1)[0]
            rec["one_card_host_ms"] = host_ms(one, calls=5, warmup=1)[0]
            rec["launches"] = c
            emit(rec)
            # the ring: 2 hops x 2 shards x 3 blocks of kernel 5 and no
            # fused MLP; the one-card forward beside it: 3 forwards and, in
            # bf16, 3 fused MLPs
            check(c["flash_attn_fwd_dyn"] == 12
                  and c["fused_ln_mlp"] == (3 if prec == "bf16" else 0),
                  f"phase 16 SP ring launches {c}")
        model.set_resolution(CARDS_DP_RES)
        n = torch.cuda.device_count() + 1
        path = os.path.join(tmp, "too_many.dtts")
        export_predict(model, path, batch_size=n, in_shape=CARDS_HW,
                       n_devices=n)
        try:
            load_exported_predict(path)
            refused = None
        except ValueError as e:
            refused = str(e)
        emit({"phase": "cards", "part": "a", "call": "load",
              "nr_devices": n, "refused": refused})
        check(refused is not None and f"exported for {n} devices" in refused,
              f"phase 16: a {n}-card artifact loaded on "
              f"{n - 1} card(s)")
        names, c = counted(lambda: trace_names_flash(model, frame, tmp))
        add_counts(total, c)
        emit({"phase": "cards", "part": "a", "call": "device_trace",
              "flash_kernels_in_trace": names})
        check(any("flash_fwd_bf16" in k for k in names),
              f"phase 16: the trace names no flash forward kernel {names}")
        emit({"phase": "cards", "part": "a", "launches": total})
        return total
    finally:
        model.set_resolution(480)
        shutil.rmtree(tmp, ignore_errors=True)


def cards_main(n, card):
    """--cards N: (b) on cards 0..N-1 of one process (and, with N > 2,
    also on cards 0 and 1): the DP artifact and the split predict_batch
    against the one-card program's bits, the SP artifact against one card
    as in (a), and the warm host ms of each beside one card's."""
    check(torch.cuda.device_count() >= max(n, 2),
          f"--cards {n} needs {max(n, 2)} cards, found "
          f"{torch.cuda.device_count()}")
    emit({"phase": "device", "names": [torch.cuda.get_device_name(i)
                                       for i in range(n)],
          "nvidia_smi": card, "torch": torch.__version__})
    _build.library()
    model = DINOSeg(head="mlp", n_blocks=3, n_classes=7, precision="bf16",
                    random_init=True, seed=0)
    tmp = tempfile.mkdtemp(prefix="dtt_cards_")
    try:
        for k in sorted({2, n}):
            for prec in ("bf16", "fp32"):
                model.set_resolution(CARDS_DP_RES)
                batch = 2 * k
                frames = cards_frames(batch, 20 + k)
                path = os.path.join(tmp, f"dp{k}_{prec}.dtts")
                export_predict(model, path, batch_size=batch,
                               in_shape=CARDS_HW, precision=prec,
                               n_devices=k)
                served = load_exported_predict(path)
                got = served(frames)
                want = one_card_chunks(model, frames, k, prec)
                whole = predict_program(model, batch, CARDS_HW, prec)
                rec = {"phase": "cards", "part": "b", "call": "dp artifact",
                       "cards": k, "batch": batch, "precision": prec,
                       "devices": [str(d) for d in served.devices],
                       "same_bits_as_one_card_program": bool(
                           (got == want).all()),
                       "artifact_host_ms": host_ms(lambda: served(frames))[0],
                       "one_card_program_host_ms": host_ms(
                           lambda: whole(frames))[0],
                       "nvidia_smi": card}
                emit(rec)
                check(rec["same_bits_as_one_card_program"],
                      f"phase 16 (b) DP artifact {rec}")
        for prec in ("bf16", "fp32"):
            model.set_resolution(CARDS_DP_RES)
            count = torch.cuda.device_count()
            frames = cards_frames(2 * count, 30)
            split = model._split_devices(len(frames), None)
            got = model.predict_batch(frames, prec)
            want = one_card_chunks(model, frames, count, prec)
            devs = [model.device]
            rec = {"phase": "cards", "part": "b", "call": "predict_batch",
                   "split_over": [str(d) for d in split or []],
                   "batch": len(frames), "precision": prec,
                   "same_bits_as_one_card_program": bool((got == want).all()),
                   "split_host_ms": host_ms(
                       lambda: model.predict_batch(frames, prec))[0],
                   "one_card_host_ms": host_ms(
                       lambda: split_labels(model, frames, devs, prec))[0],
                   "nvidia_smi": card}
            emit(rec)
            check(split is not None and len(split) == count
                  and rec["same_bits_as_one_card_program"],
                  f"phase 16 (b) predict_batch split {rec}")
        for k in sorted({2, n}):
            for prec in ("fp32", "bf16"):
                model.set_resolution(CARDS_SP_RES)
                frames = cards_frames(1, 40 + k)
                path = os.path.join(tmp, f"sp{k}_{prec}.dtts")
                export_predict(model, path, batch_size=1, in_shape=CARDS_HW,
                               precision=prec, n_devices=k,
                               parallelism="sp")
                served = load_exported_predict(path)
                rec, ring_labels = sp_check(model, served.replicas, frames,
                                            prec, "b")
                rec.update({
                    "cards": k,
                    "artifact_same_bits_as_ring": bool(
                        (served(frames) == ring_labels).all()),
                    "artifact_host_ms": host_ms(lambda: served(frames),
                                                calls=5, warmup=1)[0],
                    "one_card_host_ms": host_ms(
                        lambda: model.predict_batch(frames, prec), calls=5,
                        warmup=1)[0],
                    "nvidia_smi": card})
                rec.update(peer_copy_ms(model, frames, k, prec))
                emit(rec)
                check(rec["artifact_same_bits_as_ring"],
                      f"phase 16 (b) SP artifact {rec}")
        model.set_resolution(CARDS_DP_RES)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def peer_copy_ms(model, frames, k, precision):
    """Device ms of one ring hop's peer copy (a shard's K and V at the SP
    artifact's shape, card 0 to card 1) by CUDA events, median of 20."""
    n_local = -(-((CARDS_SP_RES // 8) ** 2 + 1) // k)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    kv = torch.zeros((2, len(frames), model.cfg.num_heads, n_local,
                      model.cfg.head_dim), dtype=dtype, device="cuda:0")
    dst = torch.device("cuda", 1)
    times = []
    for i in range(23):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        kv.to(dst, non_blocking=True)
        end.record()
        end.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
    return {"hop_copy_ms": float(np.median(times)),
            "hop_copy_bytes": kv.numel() * kv.element_size()}


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
    # kernels 3 and 6 in f32: flash_bwd_f32, behind both entries
    "flash_attn_bwd_f32": dict(
        source="dino_tpu_torch/csrc/flash_attn_bwd.cu",
        replaces="dino_tpu/ops/attention.py:580",
        tpu_kernel="_flash_bwd_kernel (f32; and _flash_bwd_kernel_dyn's)"),
    # kernel 4: the f32 K/V stream of entry dtt_flash_attn_fwd
    "flash_attn_fwd_chunked": dict(
        source="dino_tpu_torch/csrc/flash_attn_fwd.cu",
        replaces="dino_tpu/ops/attention.py:370",
        tpu_kernel="_flash_kernel_chunked"),
    "flash_attn_fwd_dyn": dict(
        source="dino_tpu_torch/csrc/flash_attn_fwd.cu",
        replaces="dino_tpu/ops/attention.py:148",
        tpu_kernel="_flash_kernel_dyn"),
    "flash_attn_bwd_dyn": dict(
        source="dino_tpu_torch/csrc/flash_attn_bwd.cu",
        replaces="dino_tpu/ops/attention.py:645",
        tpu_kernel="_flash_bwd_kernel_dyn"),
}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on "
                         "the card")
    ap = argparse.ArgumentParser()
    ap.add_argument("--sp-rank", type=int)
    ap.add_argument("--sp-world", type=int)
    ap.add_argument("--sp-store")
    ap.add_argument("--sp-backend", default="gloo")
    ap.add_argument("--dp-rank", type=int)
    ap.add_argument("--dp-world", type=int)
    ap.add_argument("--dp-store")
    ap.add_argument("--dp-backend", default="gloo")
    ap.add_argument("--tp-rank", type=int)
    ap.add_argument("--tp-world", type=int)
    ap.add_argument("--tp-store")
    ap.add_argument("--tp-backend", default="gloo")
    ap.add_argument("--pp-rank", type=int)
    ap.add_argument("--pp-world", type=int)
    ap.add_argument("--pp-store")
    ap.add_argument("--pp-backend", default="gloo")
    ap.add_argument("--cards", type=int)
    args = ap.parse_args()
    if args.sp_rank is not None:
        return sp_rank_main(args.sp_rank, args.sp_world, args.sp_store,
                            args.sp_backend)
    if args.dp_rank is not None:
        return dp_rank_main(args.dp_rank, args.dp_world, args.dp_store,
                            args.dp_backend)
    if args.tp_rank is not None:
        return tp_rank_main(args.tp_rank, args.tp_world, args.tp_store,
                            args.tp_backend)
    if args.pp_rank is not None:
        return pp_rank_main(args.pp_rank, args.pp_world, args.pp_store,
                            args.pp_backend)
    card = bench.card_name_and_power_limit()
    if args.sp_world is not None:
        return sp_cards_main(args.sp_world, card)
    if args.dp_world is not None:
        return dp_cards_main(args.dp_world, card)
    if args.tp_world is not None:
        return tp_cards_main(args.tp_world, card)
    if args.pp_world is not None:
        return pp_cards_main(args.pp_world, card)
    if args.cards is not None:
        return cards_main(args.cards, card)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.library()
    ptxas = {k: r for k, r in _build.ptxas_report(_build.build_log).items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds, "ptxas": ptxas})
    print(_build.build_log, file=sys.stderr)
    for name in NO_SPILL:
        rep = [r for k, r in ptxas.items() if name in k]
        check(rep and not any(r.get("spill_stores") or r.get("spill_loads")
                              or r.get("wgmma_serialized") for r in rep),
              f"{name} spills: {rep}")

    ranks = start_ranks("sp", SP_WORLD, "gloo")  # share the card till phase 7
    try:
        model = DINOSeg(head="mlp", n_blocks=3, n_classes=7,
                        precision="bf16", random_init=True, seed=0)
        block = model.model.dino.blocks[0]
        errs = phase_kernels(block)
        phase_edges(block)
        errs.update(phase_bwd_kernel())
        phase_bwd_edges()
        errs.update(phase_sp_kernels())

        rs = np.random.RandomState(0)
        frame = rs.randint(0, 256, (480, 640, 3)).astype(np.uint8)
        frames3 = rs.randint(0, 256, (3, 480, 640, 3)).astype(np.uint8)
        launches, per_call = phase_main_path(model, frame, frames3)
        phase_cpu_reference(model, frame)
        train, bwd_per_step, bare_fps = phase_train_path()
        sp_world1 = phase_sp_world1(model, frames3[:2])
        (launches["flash_attn_fwd_chunked"],
         errs["flash_attn_fwd_chunked"]) = phase_chunked(model, frame)
    finally:
        sp_ranks = join_sp_ranks(ranks)
    for name in ("flash_attn_bwd", "flash_attn_bwd_f32", "flash_attn_fwd_dyn",
                 "flash_attn_bwd_dyn"):
        launches[name] = train[name] + sp_world1[name] + sp_ranks[name]
    # the world of one runs fp32 steps only; the rank processes both dtypes
    for name in ("flash_attn_fwd_dyn", "flash_attn_bwd_f32"):
        check(sp_world1[name] > 0, f"{name} was never launched in SP's world "
                                   f"of one")
    for name in ("flash_attn_fwd_dyn", "flash_attn_bwd_dyn",
                 "flash_attn_bwd_f32"):
        check(sp_ranks[name] > 0, f"{name} was never launched by the SP "
                                  f"ranks")
    emit({"phase": "sp_path", "world1_launches": sp_world1,
          "rank_launches_summed": sp_ranks})
    attn = phase_attention_maps(model, frame, frames3)
    fit = phase_fit(bare_fps)
    serve = phase_serve(model, frames3)
    item8 = phase_item8(model, frames3)
    pretrain, _ = phase_pretrain()
    ranks = phase_dp()
    tp = phase_tp(bare_fps)
    pp = phase_pp()
    cards = phase_cards(model, frame)
    rows = phase_timing(block, per_call, bwd_per_step)
    rows.update(phase_timing_sp(launches))
    phase_fp32_latency(model, frame)
    emit(dict({"phase": "bench"}, **bench.run()))
    # phase 8's launches, each in one row: its bf16 forwards in row 1
    # (flash_fwd_bf16), its f32 forwards in row 4 (flash_fwd_f32), and the
    # fused MLP's
    launches["flash_attn_fwd"] += (attn["flash_attn_fwd"]
                                   - attn["flash_attn_fwd_f32"])
    launches["fused_ln_mlp"] += attn["fused_ln_mlp"]
    launches["flash_attn_fwd_chunked"] += attn["flash_attn_fwd_f32"]
    # phase 9's launches: its bf16 forwards in row 1, f32 forwards in row 4
    # and both backward kernels in their rows
    launches["flash_attn_fwd"] += (fit["flash_attn_fwd"]
                                   - fit["flash_attn_fwd_f32"])
    launches["fused_ln_mlp"] += fit["fused_ln_mlp"]
    launches["flash_attn_fwd_chunked"] += fit["flash_attn_fwd_f32"]
    launches["flash_attn_bwd"] += fit["flash_attn_bwd"]
    launches["flash_attn_bwd_f32"] += fit["flash_attn_bwd_f32"]
    # phase 10's launches as the wrappers count them (the warm-up calls,
    # the captures and the eager calls it compares with; a replay's
    # kernels are counted by the profiler, in the phase's records): its
    # bf16 forwards in row 1, f32 forwards in row 4, the fused MLP's
    launches["flash_attn_fwd"] += (serve["flash_attn_fwd"]
                                   - serve["flash_attn_fwd_f32"])
    launches["fused_ln_mlp"] += serve["fused_ln_mlp"]
    launches["flash_attn_fwd_chunked"] += serve["flash_attn_fwd_f32"]
    # phase 11's launches (int8 and MoE; the cnn path runs none): bf16
    # forwards in row 1, f32 forwards in row 4, the fused MLP's, both
    # backward kernels' and the SP step's dynamic-bound kernels
    launches["flash_attn_fwd"] += (item8["flash_attn_fwd"]
                                   - item8["flash_attn_fwd_f32"])
    launches["flash_attn_fwd_chunked"] += item8["flash_attn_fwd_f32"]
    for name in ("fused_ln_mlp", "flash_attn_bwd", "flash_attn_bwd_f32",
                 "flash_attn_fwd_dyn", "flash_attn_bwd_dyn"):
        launches[name] += item8[name]
    # phase 12's launches (the pretrain steps of (b) and (c)): bf16
    # forwards in row 1, f32 forwards in row 4, the fused MLP's (the bf16
    # teacher) and both backward kernels'
    launches["flash_attn_fwd"] += (pretrain["flash_attn_fwd"]
                                   - pretrain["flash_attn_fwd_f32"])
    launches["flash_attn_fwd_chunked"] += pretrain["flash_attn_fwd_f32"]
    for name in ("fused_ln_mlp", "flash_attn_bwd", "flash_attn_bwd_f32"):
        launches[name] += pretrain[name]
    # phase 13's rank processes' launches: bf16 forwards in row 1, f32
    # forwards in row 4, the rest in their rows
    launches["flash_attn_fwd"] += (ranks["flash_attn_fwd"]
                                   - ranks["flash_attn_fwd_f32"])
    launches["flash_attn_fwd_chunked"] += ranks["flash_attn_fwd_f32"]
    for name in ("fused_ln_mlp", "flash_attn_bwd", "flash_attn_bwd_f32",
                 "flash_attn_fwd_dyn", "flash_attn_bwd_dyn"):
        launches[name] += ranks[name]
    # phase 14's rank processes' launches, the same way (no fused MLP)
    launches["flash_attn_fwd"] += (tp["flash_attn_fwd"]
                                   - tp["flash_attn_fwd_f32"])
    launches["flash_attn_fwd_chunked"] += tp["flash_attn_fwd_f32"]
    for name in ("fused_ln_mlp", "flash_attn_bwd", "flash_attn_bwd_f32",
                 "flash_attn_fwd_dyn", "flash_attn_bwd_dyn"):
        launches[name] += tp.get(name, 0)
    # phase 15's launches (its world of one and its ranks), the same way
    launches["flash_attn_fwd"] += (pp["flash_attn_fwd"]
                                   - pp["flash_attn_fwd_f32"])
    launches["flash_attn_fwd_chunked"] += pp["flash_attn_fwd_f32"]
    for name in ("fused_ln_mlp", "flash_attn_bwd", "flash_attn_bwd_f32",
                 "flash_attn_fwd_dyn", "flash_attn_bwd_dyn"):
        launches[name] += pp.get(name, 0)
    # phase 16's launches: bf16 forwards in row 1, f32 forwards in row 4,
    # the fused MLP's and the SP ring's hops (row 5)
    launches["flash_attn_fwd"] += (cards["flash_attn_fwd"]
                                   - cards["flash_attn_fwd_f32"])
    launches["flash_attn_fwd_chunked"] += cards["flash_attn_fwd_f32"]
    for name in ("fused_ln_mlp", "flash_attn_fwd_dyn"):
        launches[name] += cards[name]
    for name in ("flash_attn_fwd", "fused_ln_mlp", "flash_attn_fwd_chunked",
                 "flash_attn_fwd_dyn"):
        check(cards[name if name != "flash_attn_fwd_chunked"
                    else "flash_attn_fwd_f32"] > 0,
              f"phase 16 launched no {name}")

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
