"""DINOSeg: the public task API of the port (inference surface).

The counterpart of ``dino_tpu/api.py``'s ``DINOSeg`` for inference:

  * ``predict`` / ``predict_batch`` return 480x480 int32 label maps whatever
    the inference resolution.  Resize, normalize, the ViT forward, the head,
    argmax and the kron upsample run on the model's device; labels cross
    back to the host as uint8 and are widened to int32 there.
  * ``predict_stream`` runs a frame iterator through one batch shape,
    enqueuing batch k+1 before it reads batch k's labels.
  * ``get_intermediate_layers`` (in the model's precision),
    ``forward_mask`` and ``get_last_selfattention`` (float32 whatever the
    precision, as in ``dino_tpu``) are the backbone's feature and
    attention-map surface.
  * ``precision='bf16'`` runs matmuls in bf16 with f32 accumulation (LN,
    softmax and log_softmax in f32) and, on CUDA, the flash and fused-MLP
    kernels; ``'fp32'`` runs true float32 (TF32 off inside the call);
    ``'int8'`` is bf16 with the blocks' qkv, proj, fc1 and fc2 as int8
    products over a per-channel quantized copy of the weights
    (``ops/quant.py``), rebuilt when the weights change, and no fused MLP.
  * ``head='moe'``: E expert MLPs behind a float32 top-1 router
    (``n_experts``; ``moe_dispatch`` 'dense' or capacity-bounded 'sparse'
    with ``moe_capacity``), trained with a load-balance term.
  * ``backbone='cnn1'`` / ``'cnn2'``: the reference's truncated ResNet-50
    baselines (``models/resnet.py``), 512-dim patch features at H/8;
    pretrained weights from ``checkpointing/pretrained.py``'s ladder.
  * ``backbone='dinov3_vith16plus'``: DINOv3 ViT-H+/16
    (``models/vit.py:dinov3_vith16plus``: RoPE, SwiGLU, LayerScale, 4
    storage tokens), its first ``n_blocks`` blocks, random weights (no
    published checkpoint is loaded); a 16-pixel label grid.  It predicts
    (``predict``, ``predict_batch``, ``predict_stream``, the serving
    program) in bf16 or fp32; int8, the parallel modes, ``fit`` and the
    attention-map calls raise.
  * checkpoints: ``dino_tpu`` ``.npz`` files and reference PL ``.ckpt``
    files load; ``save`` writes the ``.npz`` format.
  * ``fit`` trains on a VOC-style data folder (optional sim pretraining,
    best-val checkpoint, resume, early stopping, the frozen-feature cache,
    a final test pass on the reloaded best checkpoint); ``evaluate`` gives
    the metrics of a checkpoint on one split.  The host loads and augments
    batch k+1 on a prefetch thread into pinned memory while the card runs
    step k; losses and confusion matrices stay on the device until the
    epoch ends.  ``freeze_backbone`` / ``freeze_bb`` / ``unfreeze_bb``
    choose what the train step (``train/loop.py``) updates.
  * ``parallelism='sp'`` shards the token axis over the ranks of the default
    ``torch.distributed`` process group (ring attention,
    ``parallel/ring_attention.py``); ``'tp'`` splits every block's heads and
    hidden columns over them instead (Megatron tensor parallelism,
    ``parallel/tp.py``: the multi-card batch-1 latency mode) and the MoE
    head's experts.  Either way every rank calls with the same frames and
    gets the full maps.
  * training over ranks: under a ``torch.distributed`` world of W
    processes (``torchrun``, or ``parallel.dist.init_distributed_mode``),
    ``fit`` trains one replica as ``dino_tpu`` does on a mesh of W devices:
    every rank walks the same global batch windows and takes its slab of
    each, the gradients are summed over the ranks (data parallelism), and
    rank 0 alone saves, logs and writes resume files.  ``zero=True``
    shards the optimizer's moments over the ranks (ZeRO-1), ``fsdp=True``
    the parameters, gradients and moments, the step gathering one block at
    a time and reduce-scattering its gradient (``parallel/mesh.py``);
    ``parallelism='sp'`` shards the token axis instead, and
    ``parallelism='pp'`` pipelines the blocks over the ranks, one stage a
    rank, on the 1F1B schedules (``parallel/pipeline.py``).  ``evaluate``
    splits the samples over the ranks and sums the confusion matrices.

The model runs on the card by default: ``device=None`` means ``"cuda"`` and
raises when there is none.  Pass ``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

import copy
import math
import os
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from dino_tpu_torch.checkpointing.async_writer import AsyncCheckpointer
from dino_tpu_torch.checkpointing.convert import (export_pl_checkpoint,
                                                  from_jax_params,
                                                  load_pl_checkpoint,
                                                  to_jax_params)
from dino_tpu_torch.checkpointing.io import load_checkpoint, save_checkpoint
from dino_tpu_torch.checkpointing.pretrained import load_pretrained_backbone
from dino_tpu_torch.checkpointing.resume import (load_optimizer_arrays,
                                                 optimizer_arrays,
                                                 restart_from_checkpoint)
from dino_tpu_torch.data.dataset import (DuckieSegDataset, batched_loader,
                                         epoch_indices)
from dino_tpu_torch.data.prefetch import prefetched
from dino_tpu_torch.models.heads import head_apply, init_head
from dino_tpu_torch.models.resnet import OUTPUT_DIM, build_backbone
from dino_tpu_torch.models.vit import (VIT_BACKBONES, ViTConfig,
                                       VisionTransformer, forward_mask,
                                       get_intermediate_layers,
                                       get_last_selfattention,
                                       init_vit_params)
from dino_tpu_torch.ops.preprocess import normalize_imagenet, preprocess
from dino_tpu_torch.ops.quant import quantize_vit
from dino_tpu_torch.ops.upsample import kron_upsample
from dino_tpu_torch.parallel.dist import (agree_across_hosts,
                                          all_reduce_sum_, barrier, get_rank,
                                          get_world_size,
                                          is_dist_avail_and_initialized)
from dino_tpu_torch.parallel.mesh import (FSDPOptimizer, ShardedOptimizer,
                                          materialize)
from dino_tpu_torch.parallel.pipeline import (
    make_pp_1f1b_train_step, make_pp_interleaved_1f1b_train_step,
    pp_gather_state, pp_load_optimizer_state, pp_optimizer_state,
    pp_shard_vit)
from dino_tpu_torch.parallel.ring_attention import (
    make_sp_train_step, vit_forward_seq_parallel,
    vit_forward_seq_parallel_local)
from dino_tpu_torch.parallel.tp import (check_tp_world, tp_head_apply,
                                        tp_serving_slices, tp_slice_experts,
                                        vit_forward_tp)
from dino_tpu_torch.precision import matmul_ctx
from dino_tpu_torch.train.loop import (init_opt_state,
                                       make_cached_head_eval_step,
                                       make_cached_head_train_step,
                                       make_eval_step, make_feature_fn,
                                       make_optimizer, make_train_step,
                                       seg_forward)
from dino_tpu_torch.train.metrics import (per_class_metrics_from_cm,
                                          segmentation_metrics)
from dino_tpu_torch.utils.device import on_device, resolve_device
from dino_tpu_torch.utils.logging import hbm_stats
from dino_tpu_torch.utils.profiling import annotate
from dino_tpu_torch.utils.weights import watch_optimizer_steps, weights_key

_HPARAM_KEYS = ("data_path", "write_path", "class_names", "head", "n_blocks",
                "batch_size", "lr", "optimizer", "freeze_backbone",
                "max_epochs", "patience", "grayscale", "n_classes",
                "pretrain_on_sim", "augmented", "random_init", "backbone",
                "train_resolution", "precision", "n_experts", "moe_dispatch",
                "moe_capacity")


def compute_dtype_of(precision: str) -> Optional[torch.dtype]:
    """'bf16' and 'int8' -> torch.bfloat16 (int8 quantizes the fat
    projections only; everything else runs bf16), 'fp32' -> None (true
    float32)."""
    if precision not in ("bf16", "fp32", "int8"):
        raise ValueError(f"unsupported precision {precision!r}")
    return None if precision == "fp32" else torch.bfloat16


def _world_group():
    """The default process group when it has more than one rank, else
    None (a world of one, or no ``torch.distributed`` at all)."""
    return dist.group.WORLD if get_world_size() > 1 else None


def _pad_tail(arrs, b: int):
    """Pad each array's leading axis to ``b`` by repeating its last row
    (a tensor where it lies, a host array on the host); returns (padded
    arrays, per-row mask), the mask 1 on the real rows.  The train steps
    leave the padded rows out of the loss, the gradients and the confusion
    matrix."""
    n_real = arrs[0].shape[0]
    mask = np.zeros((b,), np.float32)
    mask[:n_real] = 1.0
    if n_real != b:
        arrs = [torch.cat([a, a[-1:].expand(b - n_real, *a.shape[1:])])
                if torch.is_tensor(a) else
                np.concatenate([a, np.repeat(a[-1:], b - n_real, axis=0)])
                for a in arrs]
    return arrs, mask


class SegModel(nn.Module):
    """Backbone (ViT or ResNet) + head under the reference's
    ``dino.``/``clf.`` names."""

    def __init__(self, dino: VisionTransformer, clf: nn.Module):
        super().__init__()
        self.dino = dino
        self.clf = clf


def seg_log_probs(model: SegModel, cfg: ViTConfig, head: str,
                  imgs_u8: torch.Tensor, resolution: int,
                  compute_dtype: Optional[torch.dtype],
                  backbone: str = "vit", moe_dispatch: str = "dense",
                  moe_capacity: float = 1.25) -> torch.Tensor:
    """The single-device predict path before argmax: uint8 (B, H, W, 3) ->
    resize to ``resolution`` -> normalize -> backbone -> head ->
    (B*N, n_classes) log-probs, on ``imgs_u8``'s device.  Float32
    (``compute_dtype=None``) runs with TF32 off."""
    with matmul_ctx(compute_dtype):
        x = preprocess(imgs_u8, resolution)
        return seg_forward(model.dino, model.clf, cfg, head, pre_normalized=x,
                           compute_dtype=compute_dtype, backbone=backbone,
                           moe_dispatch=moe_dispatch,
                           moe_capacity=moe_capacity)


def seg_log_probs_sp(models, cfg: ViTConfig, head: str,
                     imgs_u8: torch.Tensor, resolution: int,
                     compute_dtype: Optional[torch.dtype],
                     moe_dispatch: str = "dense",
                     moe_capacity: float = 1.25) -> torch.Tensor:
    """:func:`seg_log_probs` with the ViT's token axis sharded over the
    devices of ``models`` (one :class:`SegModel` a shard, each on its
    device; ``imgs_u8`` on the first's) by the in-process ring
    (``parallel/ring_attention.py:vit_forward_seq_parallel_local``): the
    SP blocks (no fused MLP), the shards gathered on the first device and
    the head run there.  Every row, on the first device."""
    with matmul_ctx(compute_dtype):
        x = preprocess(imgs_u8, resolution)
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        tokens = vit_forward_seq_parallel_local([m.dino for m in models], x,
                                                cfg)
        feats = tokens[:, 1:, :].reshape(-1, cfg.embed_dim)
        return head_apply(head, models[0].clf, feats,
                          moe_dispatch=moe_dispatch,
                          moe_capacity=moe_capacity)


def concrete_device(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def replicate(model: nn.Module, devices) -> Dict[torch.device, nn.Module]:
    """One copy of ``model`` on each distinct device of ``devices`` (by
    :func:`concrete_device`); ``model`` itself stands for its own
    device."""
    own = concrete_device(next(model.parameters()).device)
    out: Dict[torch.device, nn.Module] = {}
    for dev in map(concrete_device, devices):
        if dev not in out:
            out[dev] = model if dev == own else copy.deepcopy(model).to(dev)
    return out


def backbone_arch(backbone: str) -> str:
    """'vit' for a ViT backbone name (``models/vit.py:VIT_BACKBONES``), else
    the name ('cnn1', 'cnn2'): what the forward paths dispatch on."""
    return "vit" if backbone in VIT_BACKBONES else backbone


def collect_labels(pending) -> np.ndarray:
    """Wait for the events of a (host labels, events) pair whose label maps
    are being copied into the host tensor, then -> int32 (B, H, W)."""
    host, events = pending
    with annotate("stream.wait"):
        for done in events:
            done.synchronize()
    with annotate("stream.labels"):
        return host.numpy().astype(np.int32)


def label_maps(log_probs: torch.Tensor, resolution: int,
               n_classes: int) -> torch.Tensor:
    """(B, N, n_classes) log-probs over a square grid of N patches a frame
    -> (B, 480, 480) label maps on their device (the kron factor floors:
    480 // sqrt(N), whatever the patch size), uint8 when n_classes <= 255
    (the label wire), else int32.  ``resolution`` is the frames' side,
    which the grid divides."""
    out_size = math.isqrt(log_probs.shape[-2])
    if (log_probs.dim() != 3 or out_size * out_size != log_probs.shape[-2]
            or resolution % out_size):
        raise ValueError(f"label_maps takes (B, N, C) log-probs over a "
                         f"square grid that divides {resolution}, got "
                         f"{tuple(log_probs.shape)}")
    wire = torch.uint8 if n_classes <= 255 else torch.int32
    low = log_probs.argmax(dim=-1).to(wire)
    return kron_upsample(low.reshape(-1, out_size, out_size),
                         480 // out_size)


def frame_log_probs(log_probs: torch.Tensor, frames: int) -> torch.Tensor:
    """(B*N, C) log-probs -> (B, N, C), as :func:`label_maps` takes them."""
    return log_probs.reshape(frames, -1, log_probs.shape[-1])


class DINOSeg:
    """DINO ViT-S/8 (or another ViT of ``models/vit.py:VIT_BACKBONES``, or
    a ResNet) backbone + per-patch segmentation head."""

    def __init__(self, data_path: Optional[str] = None,
                 write_path: Optional[str] = None,
                 class_names=None, head: str = "linear", n_blocks: int = 1,
                 batch_size: int = 1, lr: float = 1e-6,
                 optimizer: str = "adamw", freeze_backbone: bool = True,
                 max_epochs: int = 200, patience: int = 10,
                 grayscale: bool = False, n_classes: int = 7,
                 pretrain_on_sim: bool = False, logger=None,
                 augmented: bool = True, random_init: bool = False,
                 backbone: str = "vit", pretrained_path: Optional[str] = None,
                 seed: int = 0, train_resolution: int = 480,
                 precision: str = "bf16", n_experts: int = 4,
                 moe_dispatch: str = "dense", moe_capacity: float = 1.25,
                 comet_logger=None, device=None):
        if logger is None and comet_logger is not None:
            logger = comet_logger  # the reference's keyword
        if backbone not in ("cnn1", "cnn2") and backbone not in VIT_BACKBONES:
            raise ValueError(f"unknown backbone {backbone!r}")
        if moe_dispatch not in ("dense", "sparse"):
            raise ValueError(f"unsupported moe_dispatch {moe_dispatch!r}")
        if isinstance(optimizer, type):  # a torch.optim class
            optimizer = optimizer.__name__
        optimizer = optimizer.lower()
        self.device = resolve_device(device)
        self.hparams: Dict[str, Any] = dict(
            data_path=data_path, write_path=write_path,
            class_names=list(class_names) if class_names else None,
            head=head, n_blocks=n_blocks, batch_size=batch_size, lr=lr,
            optimizer=optimizer, freeze_backbone=freeze_backbone,
            max_epochs=max_epochs, patience=patience, grayscale=grayscale,
            n_classes=n_classes, pretrain_on_sim=pretrain_on_sim,
            augmented=augmented, random_init=random_init, backbone=backbone,
            train_resolution=train_resolution, precision=precision,
            n_experts=n_experts, moe_dispatch=moe_dispatch,
            moe_capacity=float(moe_capacity))
        self.__dict__.update(self.hparams)
        # what the forward paths dispatch on: 'vit', 'cnn1' or 'cnn2'
        self.arch = backbone_arch(backbone)
        self.cfg = (VIT_BACKBONES[backbone]() if self.arch == "vit"
                    else ViTConfig(patch_size=8))
        self._check_precision(None)
        self.class_names = tuple(class_names) if class_names else None
        self.logger = logger
        self.compute_dtype = compute_dtype_of(precision)
        self._head_kwargs = dict(moe_dispatch=moe_dispatch,
                                 moe_capacity=float(moe_capacity))
        # (weights_key of the float backbone, its int8 serving copy)
        self._int8_cache = None
        # (weights key of the backbone and head, the world, this rank's
        # tensor-parallel serving slices)
        self._tp_cache = None
        # (weights key, precision, the cards, {card: serving model}) of the
        # batch split over one process's cards
        self._split_cache = None
        self.mlp_input_dim = (self.cfg.embed_dim if self.arch == "vit"
                              else OUTPUT_DIM)
        self.resolution = 480
        self.best_ck: Optional[str] = None
        if data_path is not None:
            self.train_path = os.path.join(data_path, "dt_real_voc_train")
            self.val_path = os.path.join(data_path, "dt_real_voc_val")
            self.test_path = os.path.join(data_path, "dt_real_voc_test")
            self.train_path_sim = os.path.join(data_path, "dt_sim_voc_train")
            self.val_path_sim = os.path.join(data_path, "dt_sim_voc_val")
            self.test_path_sim = os.path.join(data_path, "dt_sim_voc_test")

        gen = torch.Generator().manual_seed(seed)
        if self.arch != "vit":
            vit = build_backbone(backbone, gen, random_init, pretrained_path)
        elif self.cfg.rope:
            # DINOv3: built and drawn on the model's device (hundreds of
            # millions of weights take tens of seconds to draw on the CPU)
            with self.device:
                vit = init_vit_params(
                    VisionTransformer(self.cfg, depth=n_blocks),
                    torch.Generator(self.device).manual_seed(seed))
        else:
            vit = init_vit_params(VisionTransformer(self.cfg, depth=n_blocks),
                                  gen)
        if not random_init and backbone != "vit" and self.arch == "vit":
            warnings.warn(f"no published weights are loaded for backbone "
                          f"{backbone!r}; using random init")
        if not random_init and backbone == "vit":
            sd = load_pretrained_backbone(pretrained_path=pretrained_path)
            if sd is not None:
                own = vit.state_dict()
                vit.load_state_dict({k: v for k, v in sd.items() if k in own},
                                    strict=True)
            else:
                warnings.warn("pretrained DINO weights unavailable; using "
                              "random init (pass pretrained_path or set "
                              "$DINO_TPU_PRETRAINED)")
        clf = init_head(head, n_classes, self.mlp_input_dim, generator=gen,
                        n_experts=n_experts)
        self.model = SegModel(vit, clf).to(self.device).eval()
        self.model.dino.requires_grad_(not freeze_backbone)

    # ------------------------------------------------------------------
    # Inference API
    # ------------------------------------------------------------------

    def set_resolution(self, resolution: int = 480) -> None:
        """The square side frames are resized to; a multiple of the
        backbone's patch size (8 for ViT-S/8 and the ResNets, 16 for
        DINOv3 ViT-H+/16)."""
        patch = self.cfg.patch_size
        if resolution % patch != 0:
            raise ValueError(f"Resolution should be a multiple of {patch}.")
        self.resolution = resolution

    def _need_classic_vit(self, what: str) -> None:
        """Raise for a path the DINOv3 (RoPE) backbone does not take (it
        runs forwards only; the module docstring)."""
        if self.arch == "vit" and self.cfg.rope:
            raise ValueError(f"{what} is not supported for backbone "
                             f"{self.backbone!r} (forwards only: predict, "
                             f"predict_batch, predict_stream, the serving "
                             f"program)")

    def _check_precision(self, precision: Optional[str]) -> str:
        precision = precision or self.precision
        compute_dtype_of(precision)
        if precision == "int8" and self.arch != "vit":
            raise ValueError("precision='int8' is only supported for the "
                             "ViT backbone")
        if precision == "int8":
            self._need_classic_vit("precision='int8'")
        return precision

    def _compute_dtype_for(self, precision: Optional[str]):
        return compute_dtype_of(self._check_precision(precision))

    def _serving_model(self, precision: Optional[str] = None) -> SegModel:
        """The model the predict paths run: the float masters, or in int8 a
        copy whose blocks hold per-channel int8 codes (the other tensors
        shared), rebuilt when the backbone's weights change (a
        ``load_state_dict``, a ``torch.optim`` step as in ``fit``; see
        ``utils/weights.py``)."""
        if self._check_precision(precision) != "int8":
            return self.model
        key = weights_key(self.model.dino)
        if self._int8_cache is None or self._int8_cache[0] != key:
            self._int8_cache = (key, SegModel(quantize_vit(self.model.dino),
                                              self.model.clf))
        return self._int8_cache[1]

    def _need_vit(self, what: str) -> None:
        if self.arch != "vit":
            raise ValueError(f"{what} requires the ViT backbone")

    @torch.no_grad()
    def forward(self, images_u8) -> torch.Tensor:
        """uint8 (B,res,res,3) -> (B*N, n_classes) log-probs."""
        cdt = self._compute_dtype_for(None)
        x = self._frames(images_u8)
        with matmul_ctx(cdt):
            return seg_forward(self.model.dino, self.model.clf, self.cfg,
                               self.head, pre_normalized=normalize_imagenet(x),
                               compute_dtype=cdt, backbone=self.arch,
                               **self._head_kwargs)

    def _check_parallel_options(self, parallelism: Optional[str],
                                precision: Optional[str] = None) -> None:
        """What ``dino_tpu``'s ``_serving_params`` refuses: another mode,
        or a parallel mode of a cnn backbone or of int8 weights."""
        if parallelism not in (None, "sp", "tp"):
            raise ValueError(f"unsupported parallelism {parallelism!r}")
        if parallelism is not None:
            self._need_vit(f"parallelism={parallelism!r}")
            self._need_classic_vit(f"parallelism={parallelism!r}")
            if self._check_precision(precision) == "int8":
                raise ValueError(f"parallelism={parallelism!r} is not "
                                 f"supported with int8 params")

    def _check_parallelism(self, parallelism: Optional[str],
                           precision: Optional[str] = None) -> None:
        self._check_parallel_options(parallelism, precision)
        if parallelism is not None and not is_dist_avail_and_initialized():
            what = "the tokens" if parallelism == "sp" else "the weights"
            raise RuntimeError(
                f"parallelism={parallelism!r} shards {what} over the default "
                "torch.distributed process group, and none is initialized: "
                "call dino_tpu_torch.parallel.dist.init_distributed_mode "
                "first (a world of one is allowed)")
        if parallelism == "tp":
            world = get_world_size()
            if self.head == "moe" and self.n_experts % world:
                raise ValueError(
                    f"parallelism='tp' with head='moe' needs n_experts "
                    f"divisible by the world size ({world}); got "
                    f"{self.n_experts}")
            check_tp_world(self.cfg, world)

    def _tp_params(self):
        """This rank's tensor-parallel serving weights over the default
        group: (each block's rank slice, the head (the MoE head: this rank's
        experts), the index of its first expert), rebuilt when the
        backbone's or the head's weights change (see ``utils/weights.py``;
        ``dino_tpu``'s ``_tp_cache``)."""
        watch_optimizer_steps()
        world, rank = get_world_size(), get_rank()
        key = (weights_key(self.model.dino), weights_key(self.model.clf),
               world, rank)
        if self._tp_cache is None or self._tp_cache[0] != key:
            blocks = tp_serving_slices(self.model.dino, self.cfg, rank,
                                       world)
            head, e0 = ((self.model.clf, 0) if self.head != "moe" else
                        tp_slice_experts(self.model.clf, rank, world))
            self._tp_cache = (key, (blocks, head, e0))
        return self._tp_cache[1]

    def _split_devices(self, batch: int, parallelism: Optional[str]):
        """The cards a ``predict_batch`` of ``batch`` frames splits over, as
        ``dino_tpu``'s ``_place_batch`` shards a batch over its devices:
        every card of the process when the model is on one, there are
        several, the batch divides by their count, no parallel mode is
        asked for and no process group of more than one rank is
        initialized (its ranks share the process's cards, one each); else
        None."""
        n = torch.cuda.device_count() if self.device.type == "cuda" else 0
        if (parallelism is not None or n < 2 or batch % n
                or get_world_size() > 1):
            return None
        return [torch.device("cuda", i) for i in range(n)]

    def _split_models(self, devices, precision: Optional[str]):
        """The serving model on each of ``devices``: the model's own on its
        device, a copy on every other, rebuilt when the weights change
        (see ``utils/weights.py``; ``_tp_params``' rule)."""
        watch_optimizer_steps()
        precision = self._check_precision(precision)
        key = (weights_key(self.model), precision,
               tuple(map(concrete_device, devices)))
        if self._split_cache is None or self._split_cache[0] != key:
            self._split_cache = (key, replicate(
                self._serving_model(precision), devices))
        reps = self._split_cache[1]
        return [reps[concrete_device(d)] for d in devices]

    @torch.no_grad()
    def _launch_split(self, imgs_u8: torch.Tensor, devices,
                      precision: Optional[str] = None):
        """Enqueue host uint8 frames (B, H, W, 3) split into
        ``len(devices)`` equal chunks, chunk i on ``devices[i]`` with that
        device's serving model, every chunk launched before any is waited
        on: the frames staged once in pinned memory (so the copies in do
        not block the host), each chunk's label maps copied into its rows
        of one pinned host tensor.  Returns (that tensor, the cards'
        events) for :func:`collect_labels`.  ``devices`` may repeat a
        device: ``['cpu'] * N`` runs the chunks in series."""
        n = len(devices)
        if imgs_u8.shape[0] % n:
            raise ValueError(f"a batch of {imgs_u8.shape[0]} does not split "
                             f"over {n} devices")
        cdt = self._compute_dtype_for(precision)
        models = self._split_models(devices, precision)
        cuda = any(torch.device(d).type == "cuda" for d in devices)
        if cuda and not imgs_u8.is_pinned():
            imgs_u8 = imgs_u8.pin_memory()
        rows = imgs_u8.shape[0] // n
        host, events = None, []
        for i, (model, chunk) in enumerate(zip(models,
                                               imgs_u8.split(rows))):
            dev = concrete_device(next(model.parameters()).device)
            with on_device(dev):
                out = label_maps(frame_log_probs(seg_log_probs(
                    model, self.cfg, self.head,
                    chunk.to(dev, non_blocking=True), self.resolution, cdt,
                    self.arch, **self._head_kwargs), chunk.shape[0]),
                    self.resolution, self.n_classes)
                if host is None:
                    host = torch.empty((imgs_u8.shape[0],) + out.shape[1:],
                                       dtype=out.dtype, pin_memory=cuda)
                host[i * rows:(i + 1) * rows].copy_(out, non_blocking=True)
                if dev.type == "cuda":
                    events.append(torch.cuda.Event())
                    events[-1].record()
        return host, events

    @torch.no_grad()
    def log_probs(self, imgs_u8: torch.Tensor,
                  precision: Optional[str] = None,
                  parallelism: Optional[str] = None) -> torch.Tensor:
        """uint8 (B, H, W, 3) on the model's device -> (B*N, n_classes)
        log-probs at the current resolution (the predict path before argmax).
        ``parallelism='sp'``: the backbone runs sequence-parallel over the
        default process group, and every rank gets every row; ``'tp'``:
        tensor-parallel over it, with the MoE head's experts split over the
        ranks."""
        self._check_parallelism(parallelism, precision)
        cdt = self._compute_dtype_for(precision)
        if parallelism is None:
            return seg_log_probs(self._serving_model(precision), self.cfg,
                                 self.head, imgs_u8, self.resolution, cdt,
                                 self.arch, **self._head_kwargs)
        with matmul_ctx(cdt):
            x = preprocess(imgs_u8, self.resolution)
            if cdt is not None:
                x = x.to(cdt)
            if parallelism == "sp":
                tokens = vit_forward_seq_parallel(self.model.dino, x,
                                                  self.cfg)
                head, e0 = self.model.clf, None
            else:
                blocks, head, e0 = self._tp_params()
                tokens = vit_forward_tp(self.model.dino, x, self.cfg,
                                        _world_group(), blocks)
            feats = tokens[:, 1:, :].reshape(-1, self.cfg.embed_dim)
            if e0 is None:
                return head_apply(self.head, head, feats,
                                  **self._head_kwargs)
            return tp_head_apply(self.head, head, feats, _world_group(), e0,
                                 **self._head_kwargs)

    @torch.no_grad()
    def predict_device(self, imgs_u8: torch.Tensor,
                       precision: Optional[str] = None,
                       parallelism: Optional[str] = None) -> torch.Tensor:
        """uint8 (B, H, W, 3) on the model's device -> (B, 480, 480) label
        maps on the device, uint8 when n_classes <= 255 (the label wire)."""
        return label_maps(frame_log_probs(
            self.log_probs(imgs_u8, precision, parallelism),
            imgs_u8.shape[0]), self.resolution, self.n_classes)

    @staticmethod
    def _as_uint8(img) -> np.ndarray:
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        return img

    def predict(self, x, precision: Optional[str] = None,
                parallelism: Optional[str] = None) -> np.ndarray:
        """Single-image inference -> 480x480 int32 ndarray."""
        return self.predict_batch(self._as_uint8(x)[None], precision,
                                  parallelism)[0]

    def predict_batch(self, images, precision: Optional[str] = None,
                      parallelism: Optional[str] = None) -> np.ndarray:
        """Batched inference: uint8 (B, H, W, 3) -> (B, 480, 480) int32.
        ``parallelism='sp'`` (sequence-parallel) or ``'tp'``
        (tensor-parallel) over the default process group; every rank passes
        the same frames and gets every map.  Without either, a batch that
        divides by the process's card count splits over its cards
        (``_split_devices``): the same maps as one card's."""
        self._check_parallelism(parallelism, precision)
        if isinstance(images, (list, tuple)):
            images = np.stack([np.asarray(im) for im in images])
        imgs = torch.from_numpy(self._as_uint8(images))
        devices = self._split_devices(imgs.shape[0], parallelism)
        if devices is not None:
            return collect_labels(self._launch_split(imgs, devices,
                                                     precision))
        labels = self.predict_device(imgs.to(self.device), precision,
                                     parallelism)
        return labels.cpu().numpy().astype(np.int32, copy=False)

    def predict_stream(self, frames, batch_size: int = 8,
                       precision: Optional[str] = None,
                       parallelism: Optional[str] = None):
        """Continuous inference over an iterable of frames (a camera
        trace): yields one (480, 480) int32 map per frame, in order.

        ``precision`` and ``parallelism`` mean what they do on
        :meth:`predict_batch`, and a batch splits over the process's cards
        as there.  The host stacks each batch into one of two
        pinned buffers and enqueues it (copy in, forward, labels copied out
        into a pinned buffer, an event) before it reads the previous
        batch's labels, so stacking batch k+1 overlaps the card's work on
        batch k.  A ragged tail is padded by repeating its last frame and
        cut on yield, so the stream runs one batch shape.  The options are
        checked here, before the first frame is read.  Under a profiler
        the staging, enqueue, wait and conversion are spans (``stream.*``,
        ``utils/profiling.py``), none open across a yield.
        """
        self._check_parallelism(parallelism, precision)
        self._compute_dtype_for(precision)
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        return self._stream(iter(frames), batch_size, precision, parallelism)

    def _stream(self, frames, batch_size, precision, parallelism):
        cuda = self.device.type == "cuda"
        devices = self._split_devices(batch_size, parallelism)
        staged = [None, None]   # pinned uint8 input batches, by parity
        labels = [None, None]   # pinned label batches, by parity

        def submit(k, n_valid):
            """Pad batch k's buffer past ``n_valid`` frames and enqueue
            it; returns ((label buffer, its events), n_valid)."""
            with annotate("stream.submit"):
                buf = staged[k % 2]
                buf[n_valid:] = buf[n_valid - 1]
                if devices is not None:
                    return (self._launch_split(buf, devices, precision),
                            n_valid)
                out = self.predict_device(
                    buf.to(self.device, non_blocking=True), precision,
                    parallelism)
                if labels[k % 2] is None or labels[k % 2].shape != out.shape:
                    labels[k % 2] = torch.empty(out.shape, dtype=out.dtype,
                                                pin_memory=cuda)
                host = labels[k % 2]
                host.copy_(out, non_blocking=True)
                events = []
                if cuda:
                    events.append(torch.cuda.Event())
                    events[-1].record()
                return (host, events), n_valid

        def read(pending):
            labels_events, n_valid = pending
            return collect_labels(labels_events)[:n_valid]

        pending, k, n = None, 0, 0
        for frame in frames:
            with annotate("stream.stage"):
                img = torch.from_numpy(self._as_uint8(frame))
                buf = staged[k % 2]
                if buf is None or buf.shape[1:] != img.shape:
                    if n:
                        raise ValueError(
                            f"frame of shape {tuple(img.shape)} in a batch "
                            f"of {tuple(buf.shape[1:])}")
                    buf = staged[k % 2] = torch.empty(
                        (batch_size,) + tuple(img.shape), dtype=torch.uint8,
                        pin_memory=cuda)
                buf[n] = img
            n += 1
            if n == batch_size:
                fut = submit(k, n)
                if pending is not None:
                    yield from read(pending)
                pending, k, n = fut, k + 1, 0
        if n:
            fut = submit(k, n)
            if pending is not None:
                yield from read(pending)
            pending = fut
        if pending is not None:
            yield from read(pending)

    def _frames(self, images_u8) -> torch.Tensor:
        return torch.as_tensor(np.asarray(images_u8), device=self.device)

    def _mask(self, cls_mask) -> torch.Tensor:
        """(n_masks, res/P, res/P) masks on the model's device."""
        mask = torch.as_tensor(np.asarray(cls_mask), device=self.device)
        grid = self.resolution // self.cfg.patch_size
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (grid, grid):
            raise ValueError(f"cls_mask must be (n_masks, {grid}, {grid}) at "
                             f"resolution {self.resolution}, got "
                             f"{tuple(mask.shape)}")
        return mask

    @torch.no_grad()
    def get_intermediate_layers(self, images_u8,
                                n: int = 1) -> List[np.ndarray]:
        """The final-LayerNorm'd tokens (B, 1+N, D) after each of the last
        ``n`` backbone blocks at the current resolution, as float32 arrays
        (bf16 values widened exactly).  Runs in the model's compute dtype:
        on the card a bf16 model takes the bf16 flash forward and the fused
        MLP."""
        self._need_vit("get_intermediate_layers")
        cdt = self._compute_dtype_for(None)
        with matmul_ctx(cdt):
            x = preprocess(self._frames(images_u8), self.resolution)
            if cdt is not None:
                x = x.to(cdt)
            outs = get_intermediate_layers(self.model.dino, x, self.cfg, n=n)
        return [t.float().cpu().numpy() for t in outs]

    @torch.no_grad()
    def forward_mask(self, image_u8, cls_mask) -> np.ndarray:
        """Embed region masks by masked CLS attention in the last block:
        image (H, W, 3) uint8, cls_mask (n_masks, res/8, res/8) binary ->
        (n_masks, D) float32.  Float32 with TF32 off whatever the model's
        precision, as in ``dino_tpu``; O(n_masks * N) memory."""
        self._need_vit("forward_mask")
        self._need_classic_vit("forward_mask")
        with matmul_ctx(None):
            x = preprocess(self._frames(image_u8)[None], self.resolution)
            out = forward_mask(self.model.dino, x, self._mask(cls_mask),
                               self.cfg)
        return out.cpu().numpy()

    @torch.no_grad()
    def get_last_selfattention(self, images_u8, cls_mask=None,
                               cls_only: bool = False) -> np.ndarray:
        """Last-block attention probabilities at the current resolution,
        float32 with TF32 off whatever the model's precision: (B, nh, N, N),
        or with ``cls_only`` the CLS query's row, (B, nh, 1, N) in O(N)
        memory (the row the attention-map consumers read; the full matrix
        is ~5 GB per frame at 960px).  A ``cls_mask`` gives the masked CLS
        rows of the first frame, (1, nh, n_masks, N)."""
        self._need_vit("get_last_selfattention")
        self._need_classic_vit("get_last_selfattention")
        with matmul_ctx(None):
            x = preprocess(self._frames(images_u8), self.resolution)
            mask = None if cls_mask is None else self._mask(cls_mask)
            attn = get_last_selfattention(self.model.dino, x, self.cfg,
                                          cls_mask=mask, cls_only=cls_only)
        return attn.cpu().numpy()

    def freeze_bb(self) -> None:
        """Train only the head (the reference's requires_grad flip)."""
        self.freeze_backbone = True
        self.hparams["freeze_backbone"] = True
        self.model.dino.requires_grad_(False)

    def unfreeze_bb(self) -> None:
        """Train the backbone and the head."""
        self.freeze_backbone = False
        self.hparams["freeze_backbone"] = False
        self.model.dino.requires_grad_(True)

    # ------------------------------------------------------------------
    # Data: the three dataloaders, evaluate
    # ------------------------------------------------------------------

    def _make_dataset(self, path: str, augmented: bool, resolution: int,
                      backend: str = "auto") -> DuckieSegDataset:
        """The one place where fit, evaluate and the dataloaders build a
        dataset (a subclass may hand in another source of frames)."""
        return DuckieSegDataset(path, augmented=augmented,
                                resolution=resolution, backend=backend)

    def train_dataloader(self, sim: bool = False, seed: int = 0,
                         samples_per_epoch: int = 1000):
        """Host batches (uint8 images, int32 grid labels) of one epoch of
        the train split (or the sim train split)."""
        ds = self._make_dataset(self.train_path_sim if sim else
                                self.train_path, self.augmented,
                                self.train_resolution)
        rng = np.random.default_rng(seed)
        idx = epoch_indices(rng, len(ds), samples_per_epoch)
        return batched_loader(ds, idx, self.batch_size, rng=rng)

    def val_dataloader(self, sim: bool = False):
        ds = self._make_dataset(self.val_path_sim if sim else self.val_path,
                                False, self.train_resolution)
        return batched_loader(ds, np.arange(len(ds)), self.batch_size)

    def test_dataloader(self):
        ds = self._make_dataset(self.test_path, False, self.train_resolution)
        return batched_loader(ds, np.arange(len(ds)), self.batch_size)

    def _feed(self, loader, pad_to: Optional[int] = None,
              stats: Optional[Dict[str, float]] = None):
        """Device batches (images, labels, mask or None) from a loader.  A
        prefetch thread runs the loader, pads a ragged batch to ``pad_to``
        rows (with its mask) and copies each host array into pinned memory
        while the card works on the previous one; the copy to the card is
        non-blocking.  Images the loader already put on the device (the
        'device augment' route) stay there and are padded there.
        ``stats["loader_wait_s"]`` adds up the time the caller waited for a
        batch."""
        cuda = self.device.type == "cuda"

        def stage(batch):
            arrs = list(batch)
            if pad_to is not None:
                arrs, mask = _pad_tail(arrs, pad_to)
                arrs.append(mask)
            host = [a if torch.is_tensor(a)
                    else torch.from_numpy(np.ascontiguousarray(a))
                    for a in arrs]
            return [h.pin_memory() if cuda and not h.is_cuda else h
                    for h in host]

        batches = prefetched(loader, stage)
        while True:
            t0 = time.perf_counter()
            got = next(batches, None)
            if stats is not None:
                stats["loader_wait_s"] += time.perf_counter() - t0
            if got is None:
                return
            dev = [h.to(self.device, non_blocking=True) for h in got[1]]
            yield dev[0], dev[1], (dev[2] if pad_to is not None else None)

    def evaluate(self, data_path: str, resolution: Optional[int] = None,
                 batch_size: Optional[int] = None, prefix: str = "test",
                 per_class: bool = False) -> Dict[str, Any]:
        """Metrics of the current weights over one VOC-style split
        directory (``JPEGImages/`` + ``SegmentationClass/*.npy``):
        ``{prefix}_acc/_F1/_iou/_support``, and with ``per_class`` a
        ``{prefix}_per_class`` list of rows.  Under a torch.distributed
        world every rank calls it: rank r evaluates samples r, r+W, ... and
        the confusion matrices are summed over the ranks."""
        res = resolution or self.train_resolution
        if res % self.cfg.patch_size != 0:
            raise ValueError(f"Resolution should be a multiple of "
                             f"{self.cfg.patch_size}.")
        ds = self._make_dataset(data_path, False, res)
        if len(ds) == 0:
            raise FileNotFoundError(f"no images under {data_path}")
        cm = self._run_eval(self._eval_step(), ds,
                            batch_size or self.batch_size)
        metrics = segmentation_metrics(cm, prefix=prefix)
        if per_class:
            metrics[f"{prefix}_per_class"] = per_class_metrics_from_cm(
                cm, self.class_names)
        return metrics

    def _eval_step(self, fsdp=None):
        return make_eval_step(self.cfg, self.head, self.n_classes,
                              compute_dtype=self.compute_dtype,
                              backbone=self.arch, fsdp=fsdp,
                              **self._head_kwargs)

    def _run_eval(self, eval_step, dataset, batch_size: int) -> np.ndarray:
        """The confusion matrix of ``dataset`` (ragged last batch kept), read
        from the card once.  In a world of W ranks rank r takes samples r,
        r+W, ... and the matrices are summed over the ranks (a rank with no
        sample joins the sum with zeros)."""
        cm = torch.zeros((self.n_classes, self.n_classes), dtype=torch.int64,
                         device=self.device)
        idx = np.arange(len(dataset))[get_rank()::get_world_size()]
        loader = batched_loader(dataset, idx, batch_size) if len(idx) else ()
        for x, y, _ in self._feed(loader):
            cm += eval_step(self.model.dino, self.model.clf, x, y)
        all_reduce_sum_([cm], _world_group())
        return cm.cpu().numpy()

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def _cache_plan(self, cache_features, n_train: int, n_val: int):
        """(cache_train, cache_val) for the frozen-feature cache: on with a
        frozen ViT backbone (a BatchNorm backbone's features change as its
        running stats train) in a world of one process; the train cache
        also needs un-augmented frames.  A budget over both caches' device bytes
        ($DINO_TPU_FEATURE_CACHE_BYTES, default 2 GB) drops the train cache
        first, then the val cache."""
        if (cache_features is False or not self.freeze_backbone
                or self.arch != "vit" or get_world_size() > 1):
            return False, False
        n_patches = (self.train_resolution // self.cfg.patch_size) ** 2
        cap = int(os.environ.get("DINO_TPU_FEATURE_CACHE_BYTES",
                                 2_000_000_000))
        itemsize = 2 if self.compute_dtype == torch.bfloat16 else 4

        def nbytes(n_items):
            return n_items * n_patches * self.cfg.embed_dim * itemsize

        want_train = (not self.augmented) and n_train > 0
        want_val = n_val > 0
        total = ((nbytes(n_train) if want_train else 0)
                 + (nbytes(n_val) if want_val else 0))
        if total > cap and want_train:
            want_train = False
            total = nbytes(n_val) if want_val else 0
        if total > cap:
            want_val = False
        return want_train, want_val

    def _precompute_features(self, ds, feature_fn):
        """Every image of ``ds`` through the frozen backbone once: ((M, N, D)
        features, (M, N) labels), on the card."""
        feats, labels = [], []
        loader = batched_loader(ds, np.arange(len(ds)), self.batch_size)
        for x, y, _ in self._feed(loader):
            feats.append(feature_fn(self.model.dino, x))
            labels.append(y)
        return torch.cat(feats), torch.cat(labels)

    def fit(self, ck_file_name: Optional[str] = None,
            samples_per_epoch: int = 1000, seed: int = 0,
            resume: bool = False, cache_features="auto",
            parallelism: Optional[str] = None,
            accum_steps: int = 1, zero: bool = False, fsdp: bool = False,
            early_stopping: bool = False,
            augment_backend: str = "auto", pp_schedule: str = "1f1b",
            pp_microbatches: Optional[int] = None, pp_chunks: int = 2,
            pp_stages: Optional[int] = None) -> Dict[str, float]:
        """Train on ``data_path``'s splits, keep the best-val checkpoint in
        ``write_path`` and return the test metrics of that checkpoint.

        Each epoch draws ``samples_per_epoch`` training samples with
        replacement from ``np.random.default_rng([seed, epoch])``, so a
        ``resume=True`` run that restarts after a finished epoch continues
        on the same batches (parameters, optimizer state and counters come
        from ``<ckpt>.resume.npz``).  ``early_stopping`` stops after
        ``max(patience, 1)`` epochs without a strict val_acc improvement.
        ``cache_features`` ('auto'/True/False): with a frozen backbone the
        backbone runs once per image and the epochs train the head on the
        cached features (the train cache needs ``augmented=False``; a world
        of one process).  ``accum_steps`` splits each batch into equal
        microbatches summed into one update.  ``augment_backend`` picks
        where the augmentation is computed ('auto': the native library
        when built, else numpy; 'native'; 'cv2': numpy; 'device': crop,
        flip, jitter and blur on the model's device, with the affine warp
        and the grid labels on the host); the drawn parameters are the same
        on every rung.  A ragged last batch is padded and masked.

        Under a torch.distributed world of W processes every rank calls
        ``fit`` with the same arguments.  When W divides ``batch_size``
        (data parallelism), every rank walks the same batch windows and
        trains on rows [r*b/W, (r+1)*b/W) of each, its augmentation drawn
        from ``default_rng([seed, epoch, 1 + r])``; otherwise every rank
        trains on the whole batch (a warning).  Rank 0 alone logs and
        writes the checkpoint and the resume file; the ranks meet at a
        barrier after each epoch.  ``zero=True`` shards the optimizer's
        moments over the ranks, ``fsdp=True`` the trainable parameters,
        their gradients and moments (``parallel/mesh.py:FSDPOptimizer``:
        each step, and each evaluation, gathers one block at a time; a
        restore runs on the host and a save gathers one unit at a time to
        the host; skipped with a warning for a frozen backbone); both are
        no-ops in a world of one, and the files they write are a plain
        run's.  The model leaves ``fit`` whole on its device.
        ``parallelism='sp'`` shards the token axis over the ranks instead
        (every rank loads the whole batch; ``zero`` then shards the
        moments over the same ranks).

        ``parallelism='pp'`` pipelines the backbone's blocks over ranks [0,
        ``pp_stages``) (default: every rank), one stage a rank
        (``parallel/pipeline.py``): ``pp_schedule='1f1b'`` on contiguous
        stages, or ``'interleaved_1f1b'`` with ``pp_chunks`` chunks a rank;
        ``pp_microbatches`` is M (default ``batch_size``).  Every rank
        loads the whole batch with the shared shuffle rng; a ragged tail
        pads and masks.  During an epoch each rank holds only its stage's
        blocks and their Adam moments on the card; at its end every rank
        joins the gather that rebuilds the standard backbone for eval, the
        best checkpoint and the resume file (written by rank 0, the
        optimizer state in the plain layout).  Ranks past ``pp_stages``
        hold no stage: they take rank 0's parameters and train metrics at
        each epoch's end.  The ViT backbone, unfrozen, with the mlp or
        linear head; not with ``zero``, ``fsdp`` or ``accum_steps``.  A
        world of one runs one stage."""
        self._need_classic_vit("fit")
        if parallelism not in (None, "sp", "pp"):
            raise ValueError(f"unsupported train parallelism {parallelism!r}")
        if parallelism == "pp":
            self._check_pp(pp_schedule, zero, fsdp, accum_steps, pp_stages,
                           pp_microbatches)
        if fsdp:
            if zero:
                raise ValueError("fsdp=True already shards the optimizer "
                                 "state; drop zero=True")
            if parallelism == "sp":
                raise ValueError("fsdp composes with the default DP path; "
                                 "under parallelism='sp' use zero=True "
                                 "(token-axis state sharding) instead")
        if accum_steps < 1 or self.batch_size % accum_steps:
            raise ValueError(f"batch_size {self.batch_size} must divide "
                             f"by accum_steps {accum_steps}")
        world = get_world_size()
        if accum_steps > 1:
            if parallelism == "sp":
                raise ValueError("accum_steps composes with the default DP "
                                 "path, not parallelism='sp' (the SP step "
                                 "shards tokens, not the batch)")
            if (world > 1 and self.batch_size % world == 0
                    and (self.batch_size // accum_steps) % world):
                raise ValueError(
                    f"with data sharding each microbatch "
                    f"({self.batch_size}//{accum_steps}) must divide by the "
                    f"world size ({world})")
        if parallelism == "sp":
            if self.arch != "vit":
                raise ValueError("parallelism='sp' requires the ViT backbone")
            if self.freeze_backbone:
                raise ValueError("parallelism='sp' is the unfrozen-finetune "
                                 "mode; frozen training needs no sequence "
                                 "sharding (use the feature cache instead)")
            self._check_parallelism("sp")
        if ck_file_name is None:
            ck_file_name = (str(self.n_blocks) + "_" + self.head
                            + ("_frozen" if self.freeze_backbone
                               else "_finetuned")
                            + ("_grayscale" if self.grayscale else ""))
        os.makedirs(self.write_path, exist_ok=True)
        ck_path = os.path.join(self.write_path, ck_file_name + ".ckpt.npz")
        kw = dict(cache_features=cache_features, accum_steps=accum_steps,
                  augment_backend=augment_backend, parallelism=parallelism,
                  zero=zero, fsdp=fsdp)
        if parallelism == "pp":
            kw["pp"] = dict(schedule=pp_schedule, chunks=pp_chunks,
                            stages=pp_stages or get_world_size(),
                            microbatches=pp_microbatches or self.batch_size)
        if self.pretrain_on_sim:
            if get_rank() == 0:
                print("Pretraining on simulation data...")
            self._fit_phase(self.train_path_sim, self.val_path, ck_path,
                            samples_per_epoch, seed, log=False, **kw)
        self._fit_phase(self.train_path, self.val_path, ck_path,
                        samples_per_epoch, seed, log=True, resume=resume,
                        early_stopping=early_stopping, **kw)
        # the test pass runs on the reloaded best checkpoint (rank 0's,
        # published by the barrier at the last epoch's end)
        params, _ = load_checkpoint(ck_path)
        self.model.load_state_dict(from_jax_params(params["vit"],
                                                   params["head"]))
        test_cm = self._run_eval(self._eval_step(), self._make_dataset(
            self.test_path, False, self.train_resolution), self.batch_size)
        metrics = segmentation_metrics(test_cm, prefix="test")
        self._log(metrics, step=-1)
        self.best_ck = ck_path
        if (get_rank() == 0 and self.logger is not None
                and hasattr(self.logger, "log_asset")):
            self.logger.log_asset(ck_path)
        return metrics

    def _check_pp(self, schedule: str, zero: bool, fsdp: bool,
                  accum_steps: int, stages: Optional[int],
                  microbatches: Optional[int]) -> None:
        """``dino_tpu``'s refusals of ``fit(parallelism='pp')``."""
        if schedule not in ("1f1b", "interleaved_1f1b"):
            raise ValueError(f"pp_schedule must be '1f1b' or "
                             f"'interleaved_1f1b', got {schedule!r}")
        if backbone_arch(self.backbone) != "vit":
            raise ValueError("parallelism='pp' requires the ViT backbone")
        if self.freeze_backbone:
            raise ValueError("parallelism='pp' pipelines the UNFROZEN "
                             "backbone; frozen training has no backbone "
                             "weights to shard (use the feature cache)")
        if self.head not in ("mlp", "linear"):
            raise ValueError("parallelism='pp' supports the mlp/linear "
                             "heads")
        if zero or fsdp:
            raise ValueError("parallelism='pp' already shards the block "
                             "weights AND their Adam moments per stage; "
                             "drop zero/fsdp")
        if accum_steps > 1:
            raise ValueError("parallelism='pp' accumulates via "
                             "pp_microbatches (the schedule's native "
                             "form); drop accum_steps")
        if stages is not None and stages > get_world_size():
            raise ValueError(f"pp_stages ({stages}) exceeds the world size "
                             f"({get_world_size()})")
        m = microbatches or self.batch_size
        if self.batch_size % m:
            raise ValueError(f"batch_size {self.batch_size} must divide "
                             f"by pp_microbatches {m}")

    def _dp_batches(self, train_ds, idx, rng, seed: int, epoch: int,
                    rank: int, world: int):
        """Rank ``rank``'s share of an epoch under data parallelism: (its
        loader, the per-row masks of its slabs).  Every rank walks the same
        windows of ``batch_size`` indices, each padded to the full batch,
        and takes rows [rank*b/W, (rank+1)*b/W); an augmented split draws
        from ``default_rng([seed, epoch, 1 + rank])`` (``dino_tpu``'s
        process ``rank``'s pixels), else from ``rng``, the epoch's."""
        bs = self.batch_size
        b_loc = bs // world
        slabs, masks = [], []
        for start in range(0, len(idx), bs):
            (window,), mask = _pad_tail([idx[start:start + bs]], bs)
            slabs.append(window[rank * b_loc:(rank + 1) * b_loc])
            masks.append(mask[rank * b_loc:(rank + 1) * b_loc])
        if train_ds.augmented:
            rng = np.random.default_rng([seed, epoch, 1 + rank])
        loader = (batched_loader(train_ds, np.concatenate(slabs), b_loc,
                                 rng=rng, device=self.device)
                  if slabs else ())
        return loader, masks

    def _fit_phase(self, train_path: str, val_path: str, ck_path: str,
                   samples_per_epoch: int, seed: int, log: bool,
                   resume: bool = False, cache_features="auto",
                   accum_steps: int = 1, early_stopping: bool = False,
                   augment_backend: str = "auto",
                   parallelism: Optional[str] = None, zero: bool = False,
                   fsdp: bool = False, pp: Optional[dict] = None) -> None:
        res, bs = self.train_resolution, self.batch_size
        train_ds = self._make_dataset(train_path, self.augmented, res,
                                      augment_backend)
        val_ds = self._make_dataset(val_path, False, res)
        if len(train_ds) == 0:
            raise FileNotFoundError(f"no training images under {train_path}")
        vit, head = self.model.dino, self.model.clf
        world, rank = get_world_size(), get_rank()
        group = _world_group()
        # data parallelism: the batch splits over the ranks when it divides
        dp = group if parallelism is None and bs % world == 0 else None
        if group is not None and parallelism is None and dp is None:
            warnings.warn(
                f"batch_size {bs} does not divide the world of {world} "
                "processes: data parallelism cannot engage, every process "
                "trains on the full data (correct but unscaled)")
        zero_mesh = fsdp_mesh = None
        if zero and dp is not None:
            zero_mesh = dp
        if fsdp and group is not None:
            if self.freeze_backbone:
                warnings.warn("fsdp=True skipped: freeze_backbone leaves "
                              "only the head trainable (memory-trivial); "
                              "FSDP shards the UNFROZEN train state")
            else:
                fsdp_mesh = group
                if dp is None:
                    warnings.warn(
                        f"fsdp=True with batch_size {bs} not divisible by "
                        f"{world} processes: every process computes the "
                        "full batch (state memory still shards 1/N)")
        optimizer = make_optimizer(self.optimizer, self.lr)
        # pipeline parallelism builds its optimizer over the rank's stage
        # after a resume restore (below)
        opt_state = (None if pp is not None else init_opt_state(
            optimizer, vit, head, self.freeze_backbone, zero_mesh=zero_mesh,
            fsdp_mesh=fsdp_mesh))
        sp_zero = parallelism == "sp" and zero and group is not None
        if sp_zero:  # ZeRO-1 over the ranks the tokens shard on
            opt_state = ShardedOptimizer(opt_state, group)
        cache_train, cache_val = self._cache_plan(cache_features,
                                                  len(train_ds), len(val_ds))
        train_feats = val_feats = None
        cache_bytes = 0
        if cache_train or cache_val:
            feature_fn = make_feature_fn(self.cfg, self.compute_dtype)
            if cache_val:
                val_feats, val_labels = self._precompute_features(
                    val_ds, feature_fn)
                cached_eval_step = make_cached_head_eval_step(
                    self.head, self.n_classes, **self._head_kwargs)
            if cache_train:
                train_feats, train_labels = self._precompute_features(
                    train_ds, feature_fn)
                cached_train_step = make_cached_head_train_step(
                    self.head, self.n_classes, optimizer, **self._head_kwargs)
            cache_bytes = sum(f.numel() * f.element_size() for f in
                              (train_feats, val_feats) if f is not None)
            print(f"feature cache: train={cache_train} val={cache_val} "
                  f"({cache_bytes / 1e6:.0f} MB on the device; the frozen "
                  f"backbone runs once per image)")
        if pp is not None:
            stage_group, train_step = self._pp_plan(pp, optimizer, group)
        elif parallelism == "sp":
            train_step = make_sp_train_step(
                self.cfg, self.head, self.n_classes, optimizer,
                compute_dtype=self.compute_dtype, zero=sp_zero,
                **self._head_kwargs)
        elif not cache_train:
            train_step = make_train_step(self.cfg, self.head, self.n_classes,
                                         optimizer, self.freeze_backbone,
                                         compute_dtype=self.compute_dtype,
                                         accum_steps=accum_steps,
                                         backbone=self.arch,
                                         zero_mesh=zero_mesh,
                                         fsdp_mesh=fsdp_mesh, dp_group=dp,
                                         **self._head_kwargs)
        fsdp_opt = opt_state if isinstance(opt_state, FSDPOptimizer) else None
        # under FSDP the eval runs one unit gathered at a time too
        eval_step = self._eval_step(fsdp_opt)

        # saves go through the writer thread; the copy to the host stays
        # synchronous (the loop updates the tensors in place)
        ck_writer = AsyncCheckpointer(name="fit-ckpt")
        resume_path = ck_path + ".resume.npz"
        start_epoch, best_acc, since_improve = 0, -1.0, 0
        pp_restored = svit = None
        have_resume = os.path.exists(resume_path)
        if resume and group is not None:
            # rank 0 alone writes resume files: every rank must see one
            agree_across_hosts("resume-state visibility", int(have_resume))
        if resume and have_resume:
            run_vars = {"epoch": 0, "best_acc": -1.0, "since_improve": 0}
            if fsdp_opt is not None:  # the restore runs on the host
                fsdp_opt.to_host()
            vit_p, head_p = to_jax_params(self.model.state_dict())
            restored = restart_from_checkpoint(
                resume_path, run_vars, vit=vit_p, head=head_p,
                opt_state=(None if opt_state is None
                           else optimizer_arrays(opt_state)))
            self.model.load_state_dict(from_jax_params(restored["vit"],
                                                       restored["head"]))
            if fsdp_opt is not None:  # only the shards go to the card
                fsdp_opt.from_host()
            if pp is None:
                load_optimizer_arrays(opt_state, restored["opt_state"])
            else:  # the plain layout: each stage takes its entries below
                pp_restored = restored["opt_state"]
            start_epoch = int(run_vars["epoch"]) + 1
            best_acc = float(run_vars["best_acc"])
            since_improve = int(run_vars["since_improve"])
            if group is not None:  # a torn or stale read fails fast
                agree_across_hosts("resume epoch/best_acc",
                                   [start_epoch, best_acc])

        if pp is not None and get_rank() < pp["stages"]:
            # this rank's stage, restacked from the (restored) backbone
            svit = pp_shard_vit(vit, stage_group,
                                pp["chunks"] if pp["schedule"]
                                == "interleaved_1f1b" else 1)
            opt_state = init_opt_state(optimizer, svit, head, False)
            if pp_restored is not None:
                pp_load_optimizer_state(opt_state, svit, head, vit,
                                        pp_restored)

        patience = max(self.patience, 1)
        for epoch in range(start_epoch, self.max_epochs):
            # a resumed run that had already run out of patience stops here
            if early_stopping and since_improve >= patience:
                if rank == 0:
                    print(f"[early stopping] resumed with since_improve="
                          f"{since_improve} >= patience {self.patience}; "
                          f"not training further")
                break
            t0, cpu0 = time.time(), time.process_time()
            rng = np.random.default_rng([seed, epoch])
            idx = epoch_indices(rng, len(train_ds), samples_per_epoch)
            # losses and confusion matrices stay on the card until the
            # epoch ends: reading one per step would stall the pipeline
            losses, cms = [], []
            stats = {"loader_wait_s": 0.0}
            if train_feats is not None:
                n_steps = -(-len(idx) // bs)
                ids, masks = zip(*[
                    _pad_tail([idx[i * bs:(i + 1) * bs].astype(np.int64)],
                              bs) for i in range(n_steps)])
                ids = torch.from_numpy(np.stack([i[0] for i in ids])).to(
                    self.device)
                masks = torch.from_numpy(np.stack(masks)).to(self.device)
                for i in range(n_steps):
                    loss, cm = cached_train_step(head, opt_state, train_feats,
                                                 train_labels, ids[i],
                                                 masks[i])
                    losses.append(loss)
                    cms.append(cm)
            elif pp is not None:
                if svit is not None:
                    # the epoch holds only the stage's blocks on the card
                    vit.blocks.to("cpu")
                    loader = batched_loader(train_ds, idx, bs, rng=rng,
                                            device=self.device)
                    for x, y, mask in self._feed(loader, pad_to=bs,
                                                 stats=stats):
                        loss, cm = train_step(svit, head, opt_state, x, y,
                                              mask)
                        losses.append(loss)
                        cms.append(cm)
                losses, cms = self._pp_epoch_end(
                    svit, stage_group, losses, cms, -(-len(idx) // bs),
                    pp["stages"])
            elif dp is not None:
                loader, masks = self._dp_batches(train_ds, idx, rng, seed,
                                                 epoch, rank, world)
                for (x, y, _), m in zip(self._feed(loader, stats=stats),
                                        masks):
                    loss, cm = train_step(vit, head, opt_state, x, y,
                                          torch.from_numpy(m).to(self.device))
                    losses.append(loss)
                    cms.append(cm)
            else:
                loader = batched_loader(train_ds, idx, bs, rng=rng,
                                        device=self.device)
                for x, y, mask in self._feed(loader, pad_to=bs, stats=stats):
                    loss, cm = train_step(vit, head, opt_state, x, y, mask)
                    losses.append(loss)
                    cms.append(cm)
            losses = torch.stack(losses).cpu().numpy()
            train_cm = torch.stack(cms).sum(0).cpu().numpy()
            train_s = time.time() - t0
            host_cpu_s = time.process_time() - cpu0

            if val_feats is not None:
                val_cm = cached_eval_step(head, val_feats,
                                          val_labels).cpu().numpy()
            else:
                val_cm = self._run_eval(eval_step, val_ds, bs)
            metrics = segmentation_metrics(val_cm, prefix="val")
            metrics.update(segmentation_metrics(train_cm, prefix="train"))
            metrics["train_loss"] = float(np.mean([float(l) for l in losses]))
            metrics["epoch_time_s"] = time.time() - t0
            # the host pipeline's share of the epoch (eval excluded)
            metrics["train_time_s"] = train_s
            metrics["train_steps"] = len(losses)
            metrics["train_frames_per_s"] = len(idx) / train_s
            metrics["loader_wait_s"] = stats["loader_wait_s"]
            metrics["host_cpu_s"] = host_cpu_s
            if cache_bytes:
                metrics["feature_cache_bytes"] = cache_bytes
            hbm = hbm_stats(self.device)
            if hbm is not None:
                metrics["hbm_peak_gb"] = round(
                    hbm["peak_bytes_in_use"] / 2**30, 3)
                metrics["hbm_util"] = round(hbm["utilization"], 4)
            if log:
                self._log(metrics, step=epoch)
                if (rank == 0 and self.logger is not None
                        and hasattr(self.logger, "log_confusion_matrix")):
                    self.logger.log_confusion_matrix(
                        val_cm, title="val", step=epoch,
                        labels=self.class_names,
                        file_name=f"val_epoch_{epoch}.json")
            # from the summed confusion matrices: the same on every rank
            improved = metrics["val_acc"] > best_acc
            since_improve = 0 if improved else since_improve + 1
            # the sharded optimizer's state gathers on every rank (a PP
            # stage's over the stage group, in the plain layout)
            opt_arrays = None
            if fsdp_opt is not None and (improved or resume):
                fsdp_opt.to_host()  # every rank, one unit at a time
            if resume and pp is None:
                opt_arrays = optimizer_arrays(opt_state)
            elif resume and svit is not None:
                opt_arrays = pp_optimizer_state(opt_state, svit, head, vit,
                                                stage_group)
            if rank == 0:
                if improved:
                    self.save(ck_path, extra_hparams={
                        "best_val_acc": metrics["val_acc"], "epoch": epoch})
                if resume:
                    vit_p, head_p = to_jax_params(self.model.state_dict())
                    ck_writer.save_train_state(
                        resume_path,
                        {"vit": vit_p, "head": head_p,
                         "opt_state": opt_arrays},
                        run_variables={"epoch": epoch,
                                       "best_acc": max(best_acc,
                                                       metrics["val_acc"]),
                                       "since_improve": since_improve})
            best_acc = max(best_acc, metrics["val_acc"])
            if group is not None:
                # the barrier publishes rank 0's files to the other ranks,
                # so the resume file's write must land first
                if rank == 0:
                    ck_writer.wait()
                barrier()
            if fsdp_opt is not None:
                fsdp_opt.release()  # the host copies of the saves
            # since_improve is 0 right after an improving epoch, so
            # patience 0 must not stop an improving run
            if early_stopping and since_improve >= patience:
                if rank == 0:
                    print(f"[early stopping] val_acc has not improved for "
                          f"{since_improve} epochs (patience="
                          f"{self.patience}); stopping at epoch {epoch}")
                break
        ck_writer.close()  # the resume file is on disk, the thread joined
        materialize(opt_state)  # the model leaves fit whole

    def _pp_plan(self, pp: dict, optimizer, group):
        """(stage group, 1F1B step) of fit(parallelism='pp'): the stage
        group is ranks [0, S) (``dist.new_group``, a collective every rank
        joins, when S is less than the world); a rank past it gets no
        step."""
        stage_group = group
        if group is not None and pp["stages"] < get_world_size():
            stage_group = dist.new_group(list(range(pp["stages"])))
        if get_rank() >= pp["stages"]:
            return stage_group, None
        kw = dict(n_microbatches=pp["microbatches"],
                  compute_dtype=self.compute_dtype)
        if pp["schedule"] == "interleaved_1f1b":
            return stage_group, make_pp_interleaved_1f1b_train_step(
                self.cfg, self.head, self.n_classes, optimizer, stage_group,
                n_chunks=pp["chunks"], **kw)
        return stage_group, make_pp_1f1b_train_step(
            self.cfg, self.head, self.n_classes, optimizer, stage_group, **kw)

    def _pp_epoch_end(self, svit, stage_group, losses, cms, n_steps: int,
                      n_stages: int):
        """The end of a pipelined epoch on every rank: the stages' gather
        writes the standard backbone (its blocks back on the card), and
        ranks past the stage group take rank 0's parameters, losses and
        confusion matrix.  Returns (losses, confusion matrices) as the
        epoch loop keeps them."""
        vit = self.model.dino
        if svit is not None:
            state = pp_gather_state(svit, vit, stage_group)
            vit.blocks.to(self.device)
            with torch.no_grad():
                for name, p in vit.named_parameters():
                    p.copy_(state[name])
            loss_vec, cm = torch.stack(losses), torch.stack(cms).sum(0)
        else:
            loss_vec = torch.zeros(n_steps, device=self.device)
            cm = torch.zeros((self.n_classes, self.n_classes),
                             dtype=torch.int64, device=self.device)
        if n_stages < get_world_size():
            # rank 0's values on every rank: a sum the others add zeros to
            shared = [p.data for p in self.model.parameters()] + [loss_vec,
                                                                   cm]
            if get_rank() != 0:
                for t in shared:
                    t.zero_()
            all_reduce_sum_(shared, _world_group())
        return list(loss_vec), [cm]

    def _log(self, metrics: Dict[str, float], step: int) -> None:
        if get_rank() != 0:  # rank 0 logs for the world
            return
        msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
        print(f"[epoch {step}] {msg}")
        if self.logger is not None and hasattr(self.logger, "log_metrics"):
            self.logger.log_metrics(metrics, step=step)

    # ------------------------------------------------------------------
    # Checkpointing
    # ------------------------------------------------------------------

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load ``dino.``/``clf.`` weights (reference names), strictly."""
        self.model.load_state_dict(sd, strict=True)

    def save(self, path: str,
             extra_hparams: Optional[Dict[str, Any]] = None) -> None:
        """Write a ``dino_tpu`` ``.npz`` checkpoint (readable by both
        packages) with the hyperparameters and ``extra_hparams``."""
        vit, head = to_jax_params(self.model.state_dict())
        hp = dict(self.hparams, **(extra_hparams or {}))
        save_checkpoint(path, {"vit": vit, "head": head}, hp)

    def save_torch_checkpoint(self, path: str, epoch: int = 0,
                              global_step: int = 0) -> None:
        """Write the model as a reference PyTorch-Lightning ``.ckpt``
        (``dino.``/``clf.`` state_dict and the reference constructor's
        hyperparameters), for the mlp and linear heads."""
        export_pl_checkpoint(path, self.model.state_dict(), self.head,
                             hparams=self.hparams, epoch=epoch,
                             global_step=global_step)

    @classmethod
    def load_from_checkpoint(cls, path: str, **overrides) -> "DINOSeg":
        """Rebuild a DINOSeg from a ``dino_tpu`` ``.npz`` checkpoint or a
        reference PL ``.ckpt``/``.pth``."""
        if path.endswith((".ckpt", ".pth")):
            sd, hp = load_pl_checkpoint(path)
        else:
            params, hp = load_checkpoint(path)
            sd = from_jax_params(params["vit"], params["head"])
        kwargs = {k: hp[k] for k in _HPARAM_KEYS if k in hp}
        kwargs.update(overrides)
        random_init = kwargs.pop("random_init", False)
        model = cls(random_init=True, **kwargs)
        model.hparams["random_init"] = model.random_init = random_init
        model.load_state_dict(sd)
        return model

