"""Serving: a fixed-shape predict program, and the export artifact.

The counterpart of ``dino_tpu/serving.py``.  ``dino_tpu`` runs each predict
shape as one compiled device program and serializes that program, weights
baked in, with ``jax.export``.  The port's counterpart is
:class:`PredictProgram`, the predict path for one (batch, height, width,
precision, resolution), for any backbone and head (int8: ViT only):

  * on the card it is a ``torch.cuda.CUDAGraph`` of the predict body
    (resize -> normalize -> patchify -> blocks with the flash forward and,
    in bf16, the fused LN+MLP -> head -> argmax -> kron upsample) over a
    static uint8 input buffer and a static label buffer.  One eager call
    on a side stream builds the kernels and fills the device caches, then
    the body is captured once and replayed per call, so the host enqueues
    one graph instead of every op;
  * it reads its own copy of the weights, the dense layers' weights in the
    compute dtype (the bf16 copies the eager path casts on every call; in
    int8 the blocks' int8 codes and scales, quantized from the float
    masters as the eager int8 path's copy), and
    rebuilds the copy and recaptures when the model's parameters change
    (another tensor, an in-place write such as ``load_state_dict``, or a
    ``torch.optim`` step, as in ``fit``: :func:`weights_key`);
  * on the CPU, which only a caller who asks for it gets, the same body
    runs eagerly.

A failed capture, or a kernel that refuses to launch while it is captured,
raises: there is no eager fallback on the card.  The kernels' launch
counters (``flash_attention.launches``, ...) count the warm-up call and the
capture, not replays; count kernels in replays with ``torch.profiler``.

:func:`export_predict` writes an artifact (``.dtts``) holding the model's
configuration and its weights in serving form, and ``<path>.json``, the I/O
contract with ``dino_tpu``'s keys.  It is not a StableHLO file, and
``torch.export`` cannot trace the kernels, which are launched through
ctypes (that would need them registered as ``torch.library`` custom ops).
So, as ``dino_tpu``'s artifact needs jax, this one needs this package, for
its kernels, but no checkpoint and no ``DINOSeg``.
:func:`load_exported_predict` loads it and, on the card, captures its
program at load.

An artifact may span N cards of one process, as ``dino_tpu``'s does N
devices: ``n_devices=N`` splits the batch over them (one program a card,
each a CUDA graph on its own card, all replayed before any is waited on),
and ``parallelism='sp'`` shards the token axis instead, every card
holding the weights and the ring's K/V hops moving between them as peer
copies (``parallel/ring_attention.py:ring_attention_local``; eager, no
graph).  The contract records which (``nr_devices``, ``parallelism``),
inside the artifact as well as in its ``.json``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from dino_tpu_torch.api import (SegModel, backbone_arch, compute_dtype_of,
                                concrete_device, frame_log_probs, label_maps,
                                replicate, seg_log_probs, seg_log_probs_sp)
from dino_tpu_torch.models.heads import init_head
from dino_tpu_torch.models.resnet import OUTPUT_DIM, ResNetBackbone
from dino_tpu_torch.ops.quant import QuantLinear, quantize_vit
from dino_tpu_torch.models.vit import LayerScale, ViTConfig, VisionTransformer
from dino_tpu_torch.utils.device import on_device, resolve_device
from dino_tpu_torch.utils.profiling import annotate
from dino_tpu_torch.utils.weights import watch_optimizer_steps, weights_key

MAGIC = "dino_tpu_torch_serving_v1"
SUFFIX = ".dtts"

# one capture at a time in the process: two threads capturing at once
# would each see the other's allocations and launches
_CAPTURE_LOCK = threading.Lock()

def _quantized(vit: nn.Module) -> bool:
    return any(isinstance(m, QuantLinear) for m in vit.modules())


def serving_copy(model: SegModel, precision: str) -> SegModel:
    """A frozen copy of ``model`` with its dense layers' and convolutions'
    weights, the CLS and storage tokens and the LayerScale gammas in the
    compute dtype (bf16 for 'bf16' and 'int8'), the values the predict
    path casts the float32 masters to on every call; biases, LayerNorms, BatchNorms, the pos-embed and the MoE
    router (a float32 route) stay float32.  'int8' first quantizes the
    ViT's blocks from the float copy (a model already in int8 form keeps
    its codes).  'fp32' copies as is."""
    compute_dtype = compute_dtype_of(precision)
    out = copy.deepcopy(model).requires_grad_(False)
    if precision == "int8" and not _quantized(out.dino):
        out.dino = quantize_vit(out.dino)
    if compute_dtype is not None:
        for name, mod in out.named_modules():
            if (isinstance(mod, (nn.Linear, nn.Conv2d))
                    and not name.endswith("router")):
                mod.weight.data = mod.weight.data.to(compute_dtype)
        for name in ("cls_token", "storage_tokens"):
            if hasattr(out.dino, name):
                t = getattr(out.dino, name)
                t.data = t.data.to(compute_dtype)
        for mod in out.modules():
            if isinstance(mod, LayerScale):
                mod.gamma.data = mod.gamma.data.to(compute_dtype)
    return out


class PredictProgram:
    """The predict path for one input shape, precision and resolution over
    ``model``'s weights: ``program(frames)`` takes uint8 (B, H, W, 3) and
    returns (B, 480, 480) int32 label maps (the kron factor floors).
    Calls are serialized by the program's own lock.  Under a profiler a
    call's phases are spans (``serve.*``, ``utils/profiling.py``)."""

    def __init__(self, model: SegModel, cfg: ViTConfig, head: str,
                 n_classes: int, batch_size: int, in_shape: Sequence[int],
                 resolution: int, precision: str, device: torch.device,
                 backbone: str = "vit", moe_dispatch: str = "dense",
                 moe_capacity: float = 1.25):
        self.precision = precision
        self.compute_dtype = compute_dtype_of(precision)
        self.backbone = backbone
        self.head_kwargs = dict(moe_dispatch=moe_dispatch,
                                moe_capacity=moe_capacity)
        self.masters = model
        self.cfg, self.head, self.n_classes = cfg, head, n_classes
        self.input_shape = (batch_size, int(in_shape[0]), int(in_shape[1]), 3)
        self.resolution = resolution
        self.device = torch.device(device)
        self.builds = 0  # weight copies made (and, on the card, captures)
        self._lock = threading.Lock()
        self._key = None
        self._weights = self._graph = None
        self._static_in = self._static_out = None
        self._host_in = self._host_out = None
        watch_optimizer_steps()
        with self._lock:
            self._build()

    def _forward(self, imgs_u8: torch.Tensor) -> torch.Tensor:
        return label_maps(frame_log_probs(
            seg_log_probs(self._weights, self.cfg, self.head, imgs_u8,
                          self.resolution, self.compute_dtype,
                          backbone_arch(self.backbone), **self.head_kwargs),
            imgs_u8.shape[0]), self.resolution, self.n_classes)

    def stale(self) -> bool:
        """Whether the model's parameters changed since the last build."""
        return weights_key(self.masters) != self._key

    def _build(self) -> None:
        with annotate("serve.build"):
            self._graph = self._static_out = self._weights = None
            key = weights_key(self.masters)
            self._weights = serving_copy(self.masters, self.precision)
            if self.device.type == "cuda":
                self._capture()
            self._key = key
            self.builds += 1

    @torch.no_grad()
    def _capture(self) -> None:
        if self._static_in is None:
            self._static_in = torch.zeros(self.input_shape, dtype=torch.uint8,
                                          device=self.device)
            self._host_in = torch.empty(self.input_shape, dtype=torch.uint8,
                                        pin_memory=True)
        with _CAPTURE_LOCK, torch.cuda.device(self.device):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                # builds the kernels and fills the device caches (resize
                # taps, normalize constants, pos-embed matrices)
                self._forward(self._static_in)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # a capture stream of this card: torch.cuda.graph's default one
            # is made once, on the card current at the process's first
            # capture, and a capture on it cannot take another card's work
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(
                    self.device), capture_error_mode="thread_local"):
                out = self._forward(self._static_in)
        self._graph, self._static_out = graph, out
        self._host_out = torch.empty(out.shape, dtype=out.dtype,
                                     pin_memory=True)

    def _enqueue(self, imgs: np.ndarray) -> None:
        """Under ``_lock``: start the call on ``imgs`` (copy in, replay,
        copy out, not waited on); on the CPU, run it."""
        with annotate("serve.key"):
            stale = self.stale()
        if stale:
            self._build()
        if self._graph is None:
            with annotate("serve.launch"), torch.no_grad():
                self._host_out = self._forward(torch.from_numpy(imgs))
            return
        with torch.cuda.device(self.device):
            with annotate("serve.stage"):
                self._host_in.numpy()[...] = imgs
            with annotate("serve.launch"):
                self._static_in.copy_(self._host_in, non_blocking=True)
                self._graph.replay()
                self._host_out.copy_(self._static_out, non_blocking=True)

    def _result(self) -> np.ndarray:
        """Under ``_lock``: wait for :meth:`_enqueue`'s call, its labels."""
        if self._graph is not None:
            with annotate("serve.wait"):
                torch.cuda.current_stream(self.device).synchronize()
        with annotate("serve.labels"):
            return self._host_out.numpy().astype(np.int32)

    def __call__(self, frames) -> np.ndarray:
        with annotate("serve.call"):
            with annotate("serve.check"):
                imgs = as_frames(frames, self.input_shape, "expected input")
            with self._lock:
                self._enqueue(imgs)
                return self._result()


def as_frames(frames, shape, what: str) -> np.ndarray:
    """``frames`` as uint8 (clipped, as ``predict_batch`` does), of
    ``shape`` or a ValueError."""
    imgs = np.asarray(frames)
    if imgs.dtype != np.uint8:
        imgs = np.clip(imgs, 0, 255).astype(np.uint8)
    if imgs.shape != tuple(shape):
        raise ValueError(f"{what} {tuple(shape)}, got {imgs.shape} "
                         "(programs and artifacts are shape-bound: one per "
                         "input shape)")
    return imgs


def run_programs(programs: Sequence[PredictProgram],
                 imgs: np.ndarray) -> np.ndarray:
    """``imgs`` split into equal chunks, chunk i through ``programs[i]``:
    every program's call started before any is waited on, the labels
    joined in batch order."""
    chunks = np.split(imgs, len(programs))
    with contextlib.ExitStack() as stack:
        for prog in programs:
            stack.enter_context(prog._lock)
        for prog, chunk in zip(programs, chunks):
            prog._enqueue(chunk)
        return np.concatenate([prog._result() for prog in programs])


def predict_program(model, batch_size: int, in_shape: Sequence[int],
                    precision: Optional[str] = None) -> PredictProgram:
    """A :class:`PredictProgram` over a ``DINOSeg``'s weights at its current
    resolution, on its device (captured here on the card)."""
    return PredictProgram(model.model, model.cfg, model.head, model.n_classes,
                          batch_size, in_shape, model.resolution,
                          model._check_precision(precision), model.device,
                          model.backbone, **model._head_kwargs)


def export_predict(model, path: str, batch_size: int = 1,
                   in_shape: Tuple[int, int] = (480, 640),
                   precision: Optional[str] = None,
                   platforms=None, n_devices: Optional[int] = None,
                   parallelism: Optional[str] = None) -> str:
    """Write ``model``'s predict program for one input shape as an artifact
    (``<path>``: its configuration and serving-form weights) and
    ``<path>.json`` (the I/O contract); returns ``path``.

    The artifact runs with this package (for its kernels) and nothing else
    of the model's: see the module docstring for why it is not StableHLO.
    Any backbone and head; int8 (ViT only) stores the blocks' int8 codes
    and scales.  ``n_devices=N`` binds it to N cards of one process: the
    batch splits over them (``batch_size`` must divide by N); with
    ``parallelism='sp'`` the token axis does instead, inputs and outputs
    whole (ViT, not int8: ``dino_tpu``'s ``_serving_params`` rules)."""
    if parallelism not in (None, "sp"):
        raise ValueError(f"unsupported export parallelism {parallelism!r}")
    if parallelism == "sp" and not (n_devices and n_devices > 1):
        raise ValueError("parallelism='sp' requires n_devices >= 2 (the "
                         "token axis shards over the cards)")
    n_devices = n_devices or 1
    if parallelism is None and batch_size % n_devices:
        raise ValueError(f"batch_size {batch_size} must divide by "
                         f"n_devices {n_devices}")
    if platforms is not None and list(platforms) != ["cuda"]:
        raise ValueError(f"the port exports for platforms ['cuda'], got "
                         f"{list(platforms)}")
    precision = model._check_precision(precision)
    model._check_parallel_options(parallelism, precision)
    res = model.resolution
    out_size = res // model.cfg.patch_size
    # the kron factor floors, as dino_tpu's (480x480 at 240/480/960px)
    out_hw = out_size * (480 // out_size)
    in_sh = [batch_size, int(in_shape[0]), int(in_shape[1]), 3]
    contract = {
        "magic": MAGIC,
        "input": {"shape": in_sh, "dtype": "uint8"},
        "output": {"shape": [batch_size, out_hw, out_hw], "dtype": "int32"},
        "resolution": res,
        "head": model.head,
        "backbone": model.backbone,
        "precision": precision,
        "parallelism": parallelism,
        "platforms": ["cuda"],
        "nr_devices": n_devices,
    }
    weights = serving_copy(model.model, precision)
    torch.save({
        "magic": MAGIC,
        "contract": contract,
        "config": {"vit": dataclasses.asdict(model.cfg),
                   "n_blocks": (len(model.model.dino.blocks)
                                if model.arch == "vit" else 0),
                   "head": model.head, "n_classes": model.n_classes,
                   "backbone": model.backbone, "n_experts": model.n_experts,
                   "moe_dispatch": model.moe_dispatch,
                   "moe_capacity": model.moe_capacity},
        "state_dict": {k: v.detach().cpu()
                       for k, v in weights.state_dict().items()},
    }, path)
    with open(path + ".json", "w") as fh:
        json.dump(contract, fh, indent=1)
    return path


def artifact_devices(device: torch.device, n: int):
    """The devices an artifact for ``n`` cards runs on: cards 0..n-1 (a
    ValueError in ``dino_tpu``'s words when the process has fewer), or
    ``n`` shards in series on the CPU; a one-card artifact runs on
    ``device`` itself."""
    if n == 1:
        return [device]
    if device.type == "cpu":
        return [device] * n
    have = torch.cuda.device_count()
    if have < n:
        raise ValueError(f"artifact was exported for {n} devices; runtime "
                         f"has {have}")
    return [torch.device("cuda", i) for i in range(n)]


class ExportedPredictor:
    """Callable over a loaded artifact: uint8 frames of the contract's
    input shape -> int32 label maps of its output shape.

    An artifact for N cards runs on cards 0..N-1 (``device='cpu'``: N
    shards in series on the CPU).  Split over the batch, it holds one
    :class:`PredictProgram` a card (``programs``), each captured on its own
    card; a call copies each card's chunk in and replays every graph
    before it waits on any.  Sharded over the tokens (``parallelism
    'sp'``), every card holds the weights and each call runs the
    in-process ring eagerly (``api.py:seg_log_probs_sp``), not as a
    graph."""

    def __init__(self, path: str, device=None):
        self.device = resolve_device(device)
        art = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(art, dict) or art.get("magic") != MAGIC:
            raise ValueError(f"{path} is not a dino_tpu_torch serving "
                             "artifact")
        if os.path.exists(path + ".json"):
            with open(path + ".json") as fh:
                if json.load(fh).get("magic") != MAGIC:
                    raise ValueError(f"{path}.json is not a dino_tpu_torch "
                                     "serving contract")
        # the contract inside the artifact decides, so a deleted .json
        # changes nothing
        self.contract = art["contract"]
        conf = art["config"]
        self.n_classes = conf["n_classes"]
        self.cfg = cfg = ViTConfig(**conf["vit"])
        backbone = conf.get("backbone", "vit")
        precision = self.contract["precision"]
        self.devices = artifact_devices(self.device,
                                        self.contract.get("nr_devices", 1))
        if backbone_arch(backbone) == "vit":
            dino = VisionTransformer(cfg, depth=conf["n_blocks"])
            if precision == "int8":  # the int8 form's buffers
                dino = quantize_vit(dino)
            width = cfg.embed_dim
        else:
            dino, width = ResNetBackbone(backbone), OUTPUT_DIM
        model = SegModel(dino, init_head(conf["head"], self.n_classes, width,
                                         n_experts=conf.get("n_experts", 4)))
        model.load_state_dict(art["state_dict"], strict=True)
        model = model.to(self.devices[0]).eval().requires_grad_(False)
        self.head = conf["head"]
        self.head_kwargs = dict(moe_dispatch=conf.get("moe_dispatch",
                                                      "dense"),
                                moe_capacity=conf.get("moe_capacity", 1.25))
        reps = replicate(model, self.devices)
        self.replicas = [reps[concrete_device(d)] for d in self.devices]
        shape = self.contract["input"]["shape"]
        self.sp = self.contract.get("parallelism") == "sp"
        self.programs = []
        if not self.sp:
            per_card = shape[0] // len(self.devices)
            self.programs = [PredictProgram(
                rep, cfg, self.head, self.n_classes, per_card, shape[1:3],
                self.contract["resolution"], precision, dev, backbone,
                **self.head_kwargs)
                for rep, dev in zip(self.replicas, self.devices)]
            self.program = self.programs[0]
        self._lock = threading.Lock()

    @torch.no_grad()
    def _sp_call(self, imgs: np.ndarray) -> np.ndarray:
        first = self.devices[0]
        with self._lock, on_device(first):
            x = torch.from_numpy(imgs).to(first)
            res = self.contract["resolution"]
            out = label_maps(frame_log_probs(seg_log_probs_sp(
                self.replicas, self.cfg, self.head, x, res,
                compute_dtype_of(self.contract["precision"]),
                **self.head_kwargs), x.shape[0]), res, self.n_classes)
            return out.cpu().numpy().astype(np.int32)

    def __call__(self, frames) -> np.ndarray:
        imgs = as_frames(frames, self.contract["input"]["shape"],
                         "artifact expects input")
        if self.sp:
            return self._sp_call(imgs)
        if len(self.programs) == 1:
            return self.program(imgs)
        return run_programs(self.programs, imgs)


def load_exported_predict(path: str, device=None) -> ExportedPredictor:
    """Load an artifact written by :func:`export_predict`; it runs on the
    card (cards 0..N-1 for an N-card artifact) unless ``device='cpu'``."""
    return ExportedPredictor(path, device)
