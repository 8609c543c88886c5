"""DINOSeg: the public task API of the port (predict surface).

The counterpart of ``dino_tpu/api.py``'s ``DINOSeg`` for serving:

  * ``predict`` / ``predict_batch`` return 480x480 int32 label maps whatever
    the inference resolution.  Resize, normalize, the ViT forward, the head,
    argmax and the kron upsample run on the model's device; labels cross
    back to the host as uint8 and are widened to int32 there.
  * ``precision='bf16'`` runs matmuls in bf16 with f32 accumulation (LN,
    softmax and log_softmax in f32) and, on CUDA, the flash and fused-MLP
    kernels; ``'fp32'`` runs true float32 (TF32 off inside the call).
  * checkpoints: ``dino_tpu`` ``.npz`` files and reference PL ``.ckpt``
    files load; ``save`` writes the ``.npz`` format.
  * ``freeze_backbone`` / ``freeze_bb`` / ``unfreeze_bb`` choose what the
    train step (``train/loop.py``) updates; ``fit`` is not ported yet.
  * ``parallelism='sp'`` shards the token axis over the ranks of the default
    ``torch.distributed`` process group (ring attention,
    ``parallel/ring_attention.py``); every rank calls with the same frames
    and gets the full maps.  ``'tp'`` is not ported yet.

The model runs on the card by default: ``device=None`` means ``"cuda"`` and
raises when there is none.  Pass ``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from dino_tpu_torch.checkpointing.convert import (from_jax_params,
                                                  load_backbone_state_dict,
                                                  load_pl_checkpoint,
                                                  to_jax_params)
from dino_tpu_torch.checkpointing.io import load_checkpoint, save_checkpoint
from dino_tpu_torch.models.heads import head_apply, init_head
from dino_tpu_torch.models.vit import (ViTConfig, VisionTransformer,
                                       init_vit_params)
from dino_tpu_torch.ops.preprocess import normalize_imagenet, preprocess
from dino_tpu_torch.ops.upsample import kron_upsample
from dino_tpu_torch.parallel.dist import is_dist_avail_and_initialized
from dino_tpu_torch.parallel.ring_attention import vit_forward_seq_parallel
from dino_tpu_torch.precision import matmul_ctx
from dino_tpu_torch.train.loop import seg_forward

_HPARAM_KEYS = ("head", "n_blocks", "n_classes", "precision", "random_init",
                "backbone", "freeze_backbone")


def _roadmap(what: str, item: int) -> str:
    return (f"{what} is not ported yet (ROADMAP 'Modules to port' item "
            f"{item})")


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; raise if there is none (no silent CPU path)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dino_tpu_torch runs on the card by default and "
                               "found no CUDA device; pass device='cpu' to "
                               "run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class SegModel(nn.Module):
    """Backbone + head under the reference's ``dino.``/``clf.`` names."""

    def __init__(self, dino: VisionTransformer, clf: nn.Module):
        super().__init__()
        self.dino = dino
        self.clf = clf


class DINOSeg:
    """DINO ViT-S/8 backbone + per-patch segmentation head."""

    def __init__(self, head: str = "linear", n_blocks: int = 1,
                 n_classes: int = 7, precision: str = "bf16",
                 random_init: bool = False,
                 pretrained_path: Optional[str] = None, seed: int = 0,
                 device=None, backbone: str = "vit",
                 freeze_backbone: bool = True):
        if backbone != "vit":
            raise NotImplementedError(_roadmap(f"backbone {backbone!r}", 8))
        if precision == "int8":
            raise NotImplementedError(_roadmap("precision='int8'", 8))
        if precision not in ("bf16", "fp32"):
            raise ValueError(f"unsupported precision {precision!r}")
        if head == "moe":
            raise NotImplementedError(_roadmap("head='moe'", 8))
        self.device = resolve_device(device)
        self.hparams: Dict[str, Any] = dict(
            head=head, n_blocks=n_blocks, n_classes=n_classes,
            precision=precision, random_init=random_init, backbone=backbone,
            freeze_backbone=freeze_backbone)
        self.head, self.n_blocks, self.n_classes = head, n_blocks, n_classes
        self.precision = precision
        self.cfg = ViTConfig(patch_size=8)  # ViT-S/8
        self.resolution = 480

        gen = torch.Generator().manual_seed(seed)
        vit = init_vit_params(VisionTransformer(self.cfg, depth=n_blocks), gen)
        if not random_init:
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
        clf = init_head(head, n_classes, self.cfg.embed_dim, generator=gen)
        self.model = SegModel(vit, clf).to(self.device).eval()
        self.freeze_backbone = freeze_backbone
        self.model.dino.requires_grad_(not freeze_backbone)

    # ------------------------------------------------------------------
    # Inference API
    # ------------------------------------------------------------------

    def set_resolution(self, resolution: int = 480) -> None:
        if resolution % 8 != 0:
            raise ValueError("Resolution should be a multiple of 8.")
        self.resolution = resolution

    def _compute_dtype_for(self, precision: Optional[str]):
        precision = precision or self.precision
        if precision == "int8":
            raise NotImplementedError(_roadmap("precision='int8'", 8))
        if precision not in ("bf16", "fp32"):
            raise ValueError(f"unsupported precision {precision!r}")
        return torch.bfloat16 if precision == "bf16" else None

    @torch.no_grad()
    def forward(self, images_u8) -> torch.Tensor:
        """uint8 (B,res,res,3) -> (B*N, n_classes) log-probs."""
        cdt = self._compute_dtype_for(None)
        x = torch.as_tensor(np.asarray(images_u8), device=self.device)
        with matmul_ctx(cdt):
            return seg_forward(self.model.dino, self.model.clf, self.cfg,
                               self.head, pre_normalized=normalize_imagenet(x),
                               compute_dtype=cdt)

    @staticmethod
    def _check_parallelism(parallelism: Optional[str]) -> None:
        if parallelism == "tp":
            raise NotImplementedError(_roadmap("parallelism='tp'", 11))
        if parallelism not in (None, "sp"):
            raise ValueError(f"unsupported parallelism {parallelism!r}")
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
        self._check_parallelism(parallelism)
        cdt = self._compute_dtype_for(precision)
        with matmul_ctx(cdt):
            x = preprocess(imgs_u8, self.resolution)
            if parallelism != "sp":
                return seg_forward(self.model.dino, self.model.clf, self.cfg,
                                   self.head, pre_normalized=x,
                                   compute_dtype=cdt)
            if cdt is not None:
                x = x.to(cdt)
            tokens = vit_forward_seq_parallel(self.model.dino, x, self.cfg)
            feats = tokens[:, 1:, :].reshape(-1, self.cfg.embed_dim)
            return head_apply(self.head, self.model.clf, feats)

    @torch.no_grad()
    def predict_device(self, imgs_u8: torch.Tensor,
                       precision: Optional[str] = None,
                       parallelism: Optional[str] = None) -> torch.Tensor:
        """uint8 (B, H, W, 3) on the model's device -> (B, 480, 480) label
        maps on the device, uint8 when n_classes <= 255 (the label wire)."""
        out_size = self.resolution // 8
        low = self.log_probs(imgs_u8, precision, parallelism).argmax(dim=-1)
        wire = torch.uint8 if self.n_classes <= 255 else torch.int32
        return kron_upsample(low.to(wire).reshape(-1, out_size, out_size),
                             480 // out_size)

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
        self._check_parallelism(parallelism)
        if isinstance(images, (list, tuple)):
            images = np.stack([np.asarray(im) for im in images])
        imgs = torch.from_numpy(self._as_uint8(images)).to(self.device)
        labels = self.predict_device(imgs, precision, parallelism)
        return labels.cpu().numpy().astype(np.int32, copy=False)

    def fit(self, *args, **kwargs):
        raise NotImplementedError(_roadmap("DINOSeg.fit", 5))

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
    # Checkpointing
    # ------------------------------------------------------------------

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load ``dino.``/``clf.`` weights (reference names), strictly."""
        self.model.load_state_dict(sd, strict=True)

    def save(self, path: str) -> None:
        """Write a ``dino_tpu`` ``.npz`` checkpoint (readable by both
        packages)."""
        vit, head = to_jax_params(self.model.state_dict())
        save_checkpoint(path, {"vit": vit, "head": head}, dict(self.hparams))

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
        model.hparams["random_init"] = random_init
        model.load_state_dict(sd)
        return model

