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
from typing import Any, Dict, List, Optional

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
                                       forward_mask, get_intermediate_layers,
                                       get_last_selfattention,
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
        x = self._frames(images_u8)
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
        self._check_parallelism(parallelism)
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
        with matmul_ctx(None):
            x = preprocess(self._frames(images_u8), self.resolution)
            mask = None if cls_mask is None else self._mask(cls_mask)
            attn = get_last_selfattention(self.model.dino, x, self.cfg,
                                          cls_mask=mask, cls_only=cls_only)
        return attn.cpu().numpy()

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

