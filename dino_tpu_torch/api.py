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
    pretrained weights from a local file only (``pretrained_path`` or
    ``$DINO_TPU_PRETRAINED_RESNET``).
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
    ``parallel/ring_attention.py``); every rank calls with the same frames
    and gets the full maps.  ``'tp'`` is not ported yet.  ``fit`` and
    ``evaluate`` refuse a world of more than one process: data
    parallelism over ranks is not ported (ROADMAP item 11.1).

The model runs on the card by default: ``device=None`` means ``"cuda"`` and
raises when there is none.  Pass ``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

import os
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from dino_tpu_torch.checkpointing.async_writer import AsyncCheckpointer
from dino_tpu_torch.checkpointing.convert import (export_pl_checkpoint,
                                                  from_jax_params,
                                                  load_backbone_state_dict,
                                                  load_pl_checkpoint,
                                                  to_jax_params)
from dino_tpu_torch.checkpointing.io import load_checkpoint, save_checkpoint
from dino_tpu_torch.checkpointing.resume import (load_optimizer_arrays,
                                                 optimizer_arrays,
                                                 restart_from_checkpoint)
from dino_tpu_torch.data.dataset import (DuckieSegDataset, batched_loader,
                                         epoch_indices)
from dino_tpu_torch.data.prefetch import prefetched
from dino_tpu_torch.models.heads import head_apply, init_head
from dino_tpu_torch.models.resnet import OUTPUT_DIM, build_backbone
from dino_tpu_torch.models.vit import (ViTConfig, VisionTransformer,
                                       forward_mask, get_intermediate_layers,
                                       get_last_selfattention,
                                       init_vit_params)
from dino_tpu_torch.ops.preprocess import normalize_imagenet, preprocess
from dino_tpu_torch.ops.quant import quantize_vit
from dino_tpu_torch.ops.upsample import kron_upsample
from dino_tpu_torch.parallel.dist import (get_world_size,
                                          is_dist_avail_and_initialized)
from dino_tpu_torch.parallel.ring_attention import vit_forward_seq_parallel
from dino_tpu_torch.precision import matmul_ctx
from dino_tpu_torch.train.loop import (init_opt_state,
                                       make_cached_head_eval_step,
                                       make_cached_head_train_step,
                                       make_eval_step, make_feature_fn,
                                       make_optimizer, make_train_step,
                                       seg_forward)
from dino_tpu_torch.train.metrics import (per_class_metrics_from_cm,
                                          segmentation_metrics)
from dino_tpu_torch.utils.device import resolve_device
from dino_tpu_torch.utils.logging import hbm_stats
from dino_tpu_torch.utils.weights import weights_key

_HPARAM_KEYS = ("data_path", "write_path", "class_names", "head", "n_blocks",
                "batch_size", "lr", "optimizer", "freeze_backbone",
                "max_epochs", "patience", "grayscale", "n_classes",
                "pretrain_on_sim", "augmented", "random_init", "backbone",
                "train_resolution", "precision", "n_experts", "moe_dispatch",
                "moe_capacity")


def _roadmap(what: str, item: int) -> str:
    return (f"{what} is not ported yet (ROADMAP 'Modules to port' item "
            f"{item})")


def compute_dtype_of(precision: str) -> Optional[torch.dtype]:
    """'bf16' and 'int8' -> torch.bfloat16 (int8 quantizes the fat
    projections only; everything else runs bf16), 'fp32' -> None (true
    float32)."""
    if precision not in ("bf16", "fp32", "int8"):
        raise ValueError(f"unsupported precision {precision!r}")
    return None if precision == "fp32" else torch.bfloat16


def _refuse_world(what: str) -> None:
    """Raise under a torch.distributed world of more than one process:
    ``fit`` and ``evaluate`` do not shard by rank yet, and every rank would
    train on all the data, evaluate every sample and write the same
    checkpoint."""
    if is_dist_avail_and_initialized() and get_world_size() > 1:
        raise NotImplementedError(_roadmap(
            f"{what} over a torch.distributed world of {get_world_size()} "
            f"processes (data parallelism over ranks, item 11.1)", 11))


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


def label_maps(log_probs: torch.Tensor, resolution: int,
               n_classes: int) -> torch.Tensor:
    """(B*N, n_classes) log-probs -> (B, 480, 480) label maps on their
    device (the kron factor floors: 480 // (resolution // 8)), uint8 when
    n_classes <= 255 (the label wire), else int32."""
    out_size = resolution // 8
    wire = torch.uint8 if n_classes <= 255 else torch.int32
    low = log_probs.argmax(dim=-1).to(wire)
    return kron_upsample(low.reshape(-1, out_size, out_size),
                         480 // out_size)


class DINOSeg:
    """DINO ViT-S/8 backbone + per-patch segmentation head."""

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
        if backbone not in ("vit", "cnn1", "cnn2"):
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
        self._check_precision(None)
        self.class_names = tuple(class_names) if class_names else None
        self.logger = logger
        self.cfg = ViTConfig(patch_size=8)  # ViT-S/8
        self.compute_dtype = compute_dtype_of(precision)
        self._head_kwargs = dict(moe_dispatch=moe_dispatch,
                                 moe_capacity=float(moe_capacity))
        # (weights_key of the float backbone, its int8 serving copy)
        self._int8_cache = None
        self.mlp_input_dim = (self.cfg.embed_dim if backbone == "vit"
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
        if backbone != "vit":
            vit = build_backbone(backbone, gen, random_init, pretrained_path)
        else:
            vit = init_vit_params(VisionTransformer(self.cfg, depth=n_blocks),
                                  gen)
        if not random_init and backbone == "vit":
            path = pretrained_path or os.environ.get("DINO_TPU_PRETRAINED")
            if path:
                sd = load_backbone_state_dict(path)
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
        if resolution % 8 != 0:
            raise ValueError("Resolution should be a multiple of 8.")
        self.resolution = resolution

    def _check_precision(self, precision: Optional[str]) -> str:
        precision = precision or self.precision
        compute_dtype_of(precision)
        if precision == "int8" and self.backbone != "vit":
            raise ValueError("precision='int8' is only supported for the "
                             "ViT backbone")
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
        if self.backbone != "vit":
            raise ValueError(f"{what} requires the ViT backbone")

    @torch.no_grad()
    def forward(self, images_u8) -> torch.Tensor:
        """uint8 (B,res,res,3) -> (B*N, n_classes) log-probs."""
        cdt = self._compute_dtype_for(None)
        x = self._frames(images_u8)
        with matmul_ctx(cdt):
            return seg_forward(self.model.dino, self.model.clf, self.cfg,
                               self.head, pre_normalized=normalize_imagenet(x),
                               compute_dtype=cdt, backbone=self.backbone,
                               **self._head_kwargs)

    def _check_parallelism(self, parallelism: Optional[str],
                           precision: Optional[str] = None) -> None:
        if parallelism not in (None, "sp", "tp"):
            raise ValueError(f"unsupported parallelism {parallelism!r}")
        if parallelism is not None:
            self._need_vit(f"parallelism={parallelism!r}")
            if self._check_precision(precision) == "int8":
                raise ValueError(f"parallelism={parallelism!r} is not "
                                 f"supported with int8 params")
        if parallelism == "tp":
            raise NotImplementedError(_roadmap("parallelism='tp'", 11))
        if parallelism == "sp" and not is_dist_avail_and_initialized():
            raise RuntimeError(
                "parallelism='sp' shards the tokens over the default "
                "torch.distributed process group, and none is initialized: "
                "call dino_tpu_torch.parallel.dist.init_distributed_mode "
                "first (a world of one is allowed)")

    @torch.no_grad()
    def log_probs(self, imgs_u8: torch.Tensor,
                  precision: Optional[str] = None,
                  parallelism: Optional[str] = None) -> torch.Tensor:
        """uint8 (B, H, W, 3) on the model's device -> (B*N, n_classes)
        log-probs at the current resolution (the predict path before argmax).
        ``parallelism='sp'``: the backbone runs sequence-parallel over the
        default process group, and every rank gets every row."""
        self._check_parallelism(parallelism, precision)
        cdt = self._compute_dtype_for(precision)
        if parallelism != "sp":
            return seg_log_probs(self._serving_model(precision), self.cfg,
                                 self.head, imgs_u8, self.resolution, cdt,
                                 self.backbone, **self._head_kwargs)
        with matmul_ctx(cdt):
            x = preprocess(imgs_u8, self.resolution)
            if cdt is not None:
                x = x.to(cdt)
            tokens = vit_forward_seq_parallel(self.model.dino, x, self.cfg)
            feats = tokens[:, 1:, :].reshape(-1, self.cfg.embed_dim)
            return head_apply(self.head, self.model.clf, feats,
                              **self._head_kwargs)

    @torch.no_grad()
    def predict_device(self, imgs_u8: torch.Tensor,
                       precision: Optional[str] = None,
                       parallelism: Optional[str] = None) -> torch.Tensor:
        """uint8 (B, H, W, 3) on the model's device -> (B, 480, 480) label
        maps on the device, uint8 when n_classes <= 255 (the label wire)."""
        return label_maps(self.log_probs(imgs_u8, precision, parallelism),
                          self.resolution, self.n_classes)

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
        ``parallelism='sp'``: sequence-parallel over the default process
        group; every rank passes the same frames and gets every map."""
        self._check_parallelism(parallelism, precision)
        if isinstance(images, (list, tuple)):
            images = np.stack([np.asarray(im) for im in images])
        imgs = torch.from_numpy(self._as_uint8(images)).to(self.device)
        labels = self.predict_device(imgs, precision, parallelism)
        return labels.cpu().numpy().astype(np.int32, copy=False)

    def predict_stream(self, frames, batch_size: int = 8,
                       precision: Optional[str] = None,
                       parallelism: Optional[str] = None):
        """Continuous inference over an iterable of frames (a camera
        trace): yields one (480, 480) int32 map per frame, in order.

        ``precision`` and ``parallelism`` mean what they do on
        :meth:`predict_batch`.  The host stacks each batch into one of two
        pinned buffers and enqueues it (copy in, forward, labels copied out
        into a pinned buffer, an event) before it reads the previous
        batch's labels, so stacking batch k+1 overlaps the card's work on
        batch k.  A ragged tail is padded by repeating its last frame and
        cut on yield, so the stream runs one batch shape.  The options are
        checked here, before the first frame is read.
        """
        self._check_parallelism(parallelism, precision)
        self._compute_dtype_for(precision)
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        return self._stream(iter(frames), batch_size, precision, parallelism)

    def _stream(self, frames, batch_size, precision, parallelism):
        cuda = self.device.type == "cuda"
        staged = [None, None]   # pinned uint8 input batches, by parity
        labels = [None, None]   # pinned label batches, by parity

        def submit(k, n_valid):
            """Pad batch k's buffer past ``n_valid`` frames and enqueue
            it; returns (its label buffer, its event, n_valid)."""
            buf = staged[k % 2]
            buf[n_valid:] = buf[n_valid - 1]
            out = self.predict_device(buf.to(self.device, non_blocking=True),
                                      precision, parallelism)
            if labels[k % 2] is None or labels[k % 2].shape != out.shape:
                labels[k % 2] = torch.empty(out.shape, dtype=out.dtype,
                                            pin_memory=cuda)
            host = labels[k % 2]
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event() if cuda else None
            if done is not None:
                done.record()
            return host, done, n_valid

        def read(pending):
            host, done, n_valid = pending
            if done is not None:
                done.synchronize()
            return host[:n_valid].numpy().astype(np.int32)

        pending, k, n = None, 0, 0
        for frame in frames:
            img = torch.from_numpy(self._as_uint8(frame))
            buf = staged[k % 2]
            if buf is None or buf.shape[1:] != img.shape:
                if n:
                    raise ValueError(f"frame of shape {tuple(img.shape)} in "
                                     f"a batch of {tuple(buf.shape[1:])}")
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
        """(n_masks, res/8, res/8) masks on the model's device."""
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
        ``{prefix}_per_class`` list of rows.  Refuses a torch.distributed
        world of more than one process (not sharded by rank yet)."""
        _refuse_world("evaluate")
        res = resolution or self.train_resolution
        if res % 8 != 0:
            raise ValueError("Resolution should be a multiple of 8.")
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

    def _eval_step(self):
        return make_eval_step(self.cfg, self.head, self.n_classes,
                              compute_dtype=self.compute_dtype,
                              backbone=self.backbone, **self._head_kwargs)

    def _run_eval(self, eval_step, dataset, batch_size: int) -> np.ndarray:
        """The confusion matrix of ``dataset`` (ragged last batch kept), read
        from the card once."""
        cm = torch.zeros((self.n_classes, self.n_classes), dtype=torch.int64,
                         device=self.device)
        loader = batched_loader(dataset, np.arange(len(dataset)), batch_size)
        for x, y, _ in self._feed(loader):
            cm += eval_step(self.model.dino, self.model.clf, x, y)
        return cm.cpu().numpy()

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def _cache_plan(self, cache_features, n_train: int, n_val: int):
        """(cache_train, cache_val) for the frozen-feature cache: on with a
        frozen ViT backbone (a BatchNorm backbone's features change as its
        running stats train); the train cache also needs un-augmented
        frames.  A budget over both caches' device bytes
        ($DINO_TPU_FEATURE_CACHE_BYTES, default 2 GB) drops the train cache
        first, then the val cache."""
        if (cache_features is False or not self.freeze_backbone
                or self.backbone != "vit"):
            return False, False
        n_patches = (self.train_resolution // 8) ** 2
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
            augment_backend: str = "auto") -> Dict[str, float]:
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
        cached features (the train cache needs ``augmented=False``).
        ``accum_steps`` splits each batch into equal microbatches summed
        into one update.  ``augment_backend`` picks where the augmentation
        is computed ('auto': the native library when built, else numpy;
        'native'; 'cv2': numpy; 'device': crop, flip, jitter and blur on
        the model's device, with the affine warp and the grid labels on the
        host); the drawn parameters are the same on every rung.  A ragged
        last batch is padded and masked.  ``parallelism`` ('sp', 'pp'),
        ``zero`` and ``fsdp`` are not ported, nor is a torch.distributed
        world of more than one process (``fit`` raises under one)."""
        if parallelism not in (None, "sp", "pp"):
            raise ValueError(f"unsupported train parallelism {parallelism!r}")
        if parallelism is not None:
            raise NotImplementedError(_roadmap(
                f"fit(parallelism={parallelism!r})", 11))
        if zero or fsdp:
            raise NotImplementedError(_roadmap("fit(zero=..., fsdp=...)", 11))
        _refuse_world("fit")
        if accum_steps < 1 or self.batch_size % accum_steps:
            raise ValueError(f"batch_size {self.batch_size} must divide "
                             f"by accum_steps {accum_steps}")
        if ck_file_name is None:
            ck_file_name = (str(self.n_blocks) + "_" + self.head
                            + ("_frozen" if self.freeze_backbone
                               else "_finetuned")
                            + ("_grayscale" if self.grayscale else ""))
        os.makedirs(self.write_path, exist_ok=True)
        ck_path = os.path.join(self.write_path, ck_file_name + ".ckpt.npz")
        if self.pretrain_on_sim:
            print("Pretraining on simulation data...")
            self._fit_phase(self.train_path_sim, self.val_path, ck_path,
                            samples_per_epoch, seed, log=False,
                            cache_features=cache_features,
                            accum_steps=accum_steps,
                            augment_backend=augment_backend)
        self._fit_phase(self.train_path, self.val_path, ck_path,
                        samples_per_epoch, seed, log=True, resume=resume,
                        cache_features=cache_features,
                        accum_steps=accum_steps,
                        early_stopping=early_stopping,
                        augment_backend=augment_backend)
        # the test pass runs on the reloaded best checkpoint
        params, _ = load_checkpoint(ck_path)
        self.model.load_state_dict(from_jax_params(params["vit"],
                                                   params["head"]))
        test_cm = self._run_eval(self._eval_step(), self._make_dataset(
            self.test_path, False, self.train_resolution), self.batch_size)
        metrics = segmentation_metrics(test_cm, prefix="test")
        self._log(metrics, step=-1)
        self.best_ck = ck_path
        if self.logger is not None and hasattr(self.logger, "log_asset"):
            self.logger.log_asset(ck_path)
        return metrics

    def _fit_phase(self, train_path: str, val_path: str, ck_path: str,
                   samples_per_epoch: int, seed: int, log: bool,
                   resume: bool = False, cache_features="auto",
                   accum_steps: int = 1, early_stopping: bool = False,
                   augment_backend: str = "auto") -> None:
        res, bs = self.train_resolution, self.batch_size
        train_ds = self._make_dataset(train_path, self.augmented, res,
                                      augment_backend)
        val_ds = self._make_dataset(val_path, False, res)
        if len(train_ds) == 0:
            raise FileNotFoundError(f"no training images under {train_path}")
        vit, head = self.model.dino, self.model.clf
        optimizer = make_optimizer(self.optimizer, self.lr)
        opt_state = init_opt_state(optimizer, vit, head, self.freeze_backbone)
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
        if not cache_train:
            train_step = make_train_step(self.cfg, self.head, self.n_classes,
                                         optimizer, self.freeze_backbone,
                                         compute_dtype=self.compute_dtype,
                                         accum_steps=accum_steps,
                                         backbone=self.backbone,
                                         **self._head_kwargs)
        eval_step = self._eval_step()

        # saves go through the writer thread; the copy to the host stays
        # synchronous (the loop updates the tensors in place)
        ck_writer = AsyncCheckpointer(name="fit-ckpt")
        resume_path = ck_path + ".resume.npz"
        start_epoch, best_acc, since_improve = 0, -1.0, 0
        if resume and os.path.exists(resume_path):
            run_vars = {"epoch": 0, "best_acc": -1.0, "since_improve": 0}
            vit_p, head_p = to_jax_params(self.model.state_dict())
            restored = restart_from_checkpoint(
                resume_path, run_vars, vit=vit_p, head=head_p,
                opt_state=optimizer_arrays(opt_state))
            self.model.load_state_dict(from_jax_params(restored["vit"],
                                                       restored["head"]))
            load_optimizer_arrays(opt_state, restored["opt_state"])
            start_epoch = int(run_vars["epoch"]) + 1
            best_acc = float(run_vars["best_acc"])
            since_improve = int(run_vars["since_improve"])

        patience = max(self.patience, 1)
        for epoch in range(start_epoch, self.max_epochs):
            # a resumed run that had already run out of patience stops here
            if early_stopping and since_improve >= patience:
                print(f"[early stopping] resumed with since_improve="
                      f"{since_improve} >= patience {self.patience}; not "
                      f"training further")
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
                if (self.logger is not None
                        and hasattr(self.logger, "log_confusion_matrix")):
                    self.logger.log_confusion_matrix(
                        val_cm, title="val", step=epoch,
                        labels=self.class_names,
                        file_name=f"val_epoch_{epoch}.json")
            improved = metrics["val_acc"] > best_acc
            since_improve = 0 if improved else since_improve + 1
            if improved:
                self.save(ck_path, extra_hparams={
                    "best_val_acc": metrics["val_acc"], "epoch": epoch})
            if resume:
                vit_p, head_p = to_jax_params(self.model.state_dict())
                ck_writer.save_train_state(
                    resume_path,
                    {"vit": vit_p, "head": head_p,
                     "opt_state": optimizer_arrays(opt_state)},
                    run_variables={"epoch": epoch,
                                   "best_acc": max(best_acc,
                                                   metrics["val_acc"]),
                                   "since_improve": since_improve})
            best_acc = max(best_acc, metrics["val_acc"])
            # since_improve is 0 right after an improving epoch, so
            # patience 0 must not stop an improving run
            if early_stopping and since_improve >= patience:
                print(f"[early stopping] val_acc has not improved for "
                      f"{since_improve} epochs (patience={self.patience}); "
                      f"stopping at epoch {epoch}")
                break
        ck_writer.close()  # the resume file is on disk, the thread joined

    def _log(self, metrics: Dict[str, float], step: int) -> None:
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

