"""The segmentation forward, train step, eval step and feature function.

The counterpart of ``dino_tpu/train/loop.py`` for the ViT backbone with the
MLP or linear head:

  * ``make_optimizer``: torch-default Adam / AdamW / SGD (``torch.optim``,
    fused on the card), the hyperparameters of the JAX package's optax
    transforms; AdamW decays every parameter, as optax's unmasked ``adamw``;
  * ``make_train_step``: frozen backbone (run under ``torch.no_grad()``, the
    counterpart of ``stop_gradient``; only the head trains) or unfrozen
    (backbone and head train, attention through the flash backward), with
    ``accum_steps`` microbatches summed into one optimizer update;
  * uint8 batches are normalized on the device inside the step, and the
    step returns the loss and an on-device confusion matrix.

PyTorch updates in place: the step changes the modules' parameters and the
optimizer's state instead of returning new ones.  The MoE head, the ResNet
backbones, ZeRO and FSDP are not ported (ROADMAP items 8 and 11).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from dino_tpu_torch.models.heads import head_apply
from dino_tpu_torch.models.vit import ViTConfig, VisionTransformer, vit_forward
from dino_tpu_torch.ops.preprocess import normalize_imagenet
from dino_tpu_torch.precision import matmul_ctx
from dino_tpu_torch.train.metrics import confusion_matrix

# tokens per (micro)batch above which the unfrozen step recomputes block
# activations in the backward pass (dino_tpu/train/loop.py:172)
REMAT_TOKENS = 200_000

Optimizer = Callable[[list], torch.optim.Optimizer]


def _roadmap(what: str, item: int) -> str:
    return (f"{what} is not ported yet (ROADMAP 'Modules to port' item "
            f"{item})")


def make_optimizer(name: str, lr: float) -> Optimizer:
    """Adam / AdamW (b1 0.9, b2 0.999, eps 1e-8; AdamW weight decay 0.01)
    or SGD, as a function of the parameter list -> ``torch.optim``
    optimizer (its state is the step's ``opt_state``)."""
    name = name.lower()
    if name == "adam":
        cls, kw = torch.optim.Adam, dict(betas=(0.9, 0.999), eps=1e-8)
    elif name == "adamw":
        cls, kw = torch.optim.AdamW, dict(betas=(0.9, 0.999), eps=1e-8,
                                          weight_decay=0.01)
    elif name == "sgd":
        cls, kw = torch.optim.SGD, {}
    else:
        raise ValueError(f"unknown optimizer {name!r}")

    def build(params) -> torch.optim.Optimizer:
        params = list(params)
        on_card = bool(params) and all(p.is_cuda for p in params)
        return cls(params, lr=lr, fused=True if on_card else None, **kw)
    return build


def init_opt_state(optimizer: Optimizer, vit: VisionTransformer,
                   head: torch.nn.Module,
                   freeze_backbone: bool) -> torch.optim.Optimizer:
    """The optimizer over the head, or over the head and the backbone."""
    params = list(head.parameters())
    if not freeze_backbone:
        params += list(vit.parameters())
    return optimizer(params)


def seg_forward(vit: VisionTransformer, head: torch.nn.Module, cfg: ViTConfig,
                head_type: str, images_u8: Optional[torch.Tensor] = None,
                pre_normalized: Optional[torch.Tensor] = None,
                compute_dtype: Optional[torch.dtype] = None,
                remat: bool = False,
                freeze_backbone: bool = False) -> torch.Tensor:
    """uint8 (B,res,res,3) -> (B*N_patches, n_classes) log-probs.

    Backbone -> drop CLS -> fold patches onto the batch axis -> per-patch
    head.  Normalization runs here unless a pre-normalized tensor is given
    (the predict path resizes and normalizes upstream).
    ``compute_dtype=torch.bfloat16`` runs the matmuls in bf16; LayerNorm,
    softmax and the final log_softmax stay float32.  ``freeze_backbone``
    runs the backbone under ``torch.no_grad()``; ``remat`` recomputes its
    blocks in the backward pass.
    """
    x = (pre_normalized if pre_normalized is not None
         else normalize_imagenet(images_u8))
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and not freeze_backbone):
        tokens = vit_forward(vit, x, cfg, remat=remat)
    feats = tokens[:, 1:, :].reshape(-1, tokens.shape[-1])
    return head_apply(head_type, head, feats)


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F.nll_loss's mean over patches; ``weights`` (0/1 per patch) gives the
    mean over real patches only, so padded tail samples contribute nothing
    to the loss or the gradient."""
    picked = log_probs.gather(1, labels.long()[:, None])[:, 0]
    if weights is None:
        return -picked.mean()
    return -(picked * weights).sum() / weights.sum().clamp_min(1.0)


def make_train_step(cfg: ViTConfig, head_type: str, n_classes: int,
                    optimizer: Optimizer, freeze_backbone: bool,
                    compute_dtype: Optional[torch.dtype] = None,
                    accum_steps: int = 1, backbone: str = "vit",
                    zero_mesh=None, fsdp_mesh=None) -> Callable:
    """Returns ``step(vit, head, opt_state, images_u8, labels, mask=None)
    -> (loss, cm)``, which updates ``vit``/``head`` and ``opt_state`` (from
    :func:`init_opt_state` with the same ``optimizer``) in place.

    ``images_u8`` (B, res, res, 3) uint8, ``labels`` (B, N_patches) int and
    the optional per-sample 0/1 ``mask`` lie on the model's device; ``loss``
    (0-dim float32) and ``cm`` ((C, C) int64) stay there.

    ``accum_steps=K`` runs forward and backward over K equal microbatches,
    each contributing the SUM of its masked per-patch losses (its gradients
    add up in ``.grad``), divides by the global weight total once after the
    loop and makes one optimizer update: the masked-mean step up to the
    order of float32 sums.  The batch must divide by K.
    ``compute_dtype=None`` is true float32 (TF32 off inside the step).
    """
    if head_type == "moe":
        raise NotImplementedError(_roadmap("the MoE head", 8))
    if backbone != "vit":
        raise NotImplementedError(_roadmap(f"backbone {backbone!r}", 8))
    if zero_mesh is not None or fsdp_mesh is not None:
        raise NotImplementedError(_roadmap("ZeRO / FSDP", 11))
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def logp_of(vit, head, images):
        n_tokens = images.shape[0] * (images.shape[1] // cfg.patch_size) ** 2
        remat = (not freeze_backbone) and n_tokens > REMAT_TOKENS
        return seg_forward(vit, head, cfg, head_type, images,
                           compute_dtype=compute_dtype, remat=remat,
                           freeze_backbone=freeze_backbone)

    def monolithic(vit, head, images, labels, mask):
        logp = logp_of(vit, head, images)
        y = labels.reshape(-1)
        # per-sample mask -> per-patch weights: padded tail samples touch
        # neither the loss, the gradients nor the confusion matrix
        w = (None if mask is None else mask.to(logp.dtype).repeat_interleave(
            y.shape[0] // mask.shape[0]))
        loss = nll_loss(logp, y, w)
        loss.backward()
        cm = confusion_matrix(logp.detach().argmax(dim=-1), y, n_classes, w)
        return loss.detach(), cm

    def accumulated(vit, head, params, images, labels, mask):
        k = accum_steps
        b = images.shape[0]
        mb = b // k
        n_patch = (images.shape[1] // cfg.patch_size) ** 2
        m = (torch.ones(b, device=images.device) if mask is None
             else mask.float())
        w = m.repeat_interleave(n_patch).reshape(k, mb * n_patch)
        w_total = (m.sum() * n_patch).clamp_min(1.0)
        loss_sum = torch.zeros((), device=images.device)
        cm = torch.zeros((n_classes, n_classes), dtype=torch.int64,
                         device=images.device)
        for i in range(k):
            logp = logp_of(vit, head, images[i * mb:(i + 1) * mb])
            y = labels[i * mb:(i + 1) * mb].reshape(-1)
            picked = logp.gather(1, y.long()[:, None])[:, 0]
            ls = -(picked * w[i]).sum()
            ls.backward()
            loss_sum += ls.detach()
            cm += confusion_matrix(logp.detach().argmax(dim=-1), y,
                                   n_classes, w[i])
        for p in params:
            if p.grad is not None:
                p.grad.div_(w_total)
        return loss_sum / w_total, cm

    def step(vit, head, opt_state, images_u8, labels, mask=None):
        if accum_steps > 1 and images_u8.shape[0] % accum_steps:
            raise ValueError(
                f"batch {images_u8.shape[0]} must divide by "
                f"accum_steps={accum_steps} (microbatches are equal-sized)")
        params = [p for group in opt_state.param_groups
                  for p in group["params"]]
        with matmul_ctx(compute_dtype):
            opt_state.zero_grad(set_to_none=True)
            if accum_steps > 1:
                loss, cm = accumulated(vit, head, params, images_u8, labels,
                                       mask)
            else:
                loss, cm = monolithic(vit, head, images_u8, labels, mask)
            opt_state.step()
        return loss, cm

    return step


def make_eval_step(cfg: ViTConfig, head_type: str, n_classes: int,
                   compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """``step(vit, head, images_u8, labels) -> cm``, no gradient."""
    @torch.no_grad()
    def step(vit, head, images, labels):
        with matmul_ctx(compute_dtype):
            logp = seg_forward(vit, head, cfg, head_type, images,
                               compute_dtype=compute_dtype)
        return confusion_matrix(logp.argmax(dim=-1), labels.reshape(-1),
                                n_classes)
    return step


def make_feature_fn(cfg: ViTConfig,
                    compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """``fn(vit, images_u8) -> (B, N_patches, D)`` backbone features, the
    tensor seg_forward feeds the head, with no gradient (the frozen-backbone
    feature cache)."""
    @torch.no_grad()
    def fn(vit, images_u8):
        x = normalize_imagenet(images_u8)
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        with matmul_ctx(compute_dtype):
            return vit_forward(vit, x, cfg)[:, 1:, :]
    return fn


def make_cached_head_train_step(head_type: str, n_classes: int,
                                optimizer: Optimizer) -> Callable:
    """Head-only train step over a device-resident feature cache.

    ``step(head, opt_state, feats_all, labels_all, ids, mask=None) -> (loss,
    cm)`` gathers the batch's rows ``ids`` of ``feats_all`` ((M, N, D), the
    whole dataset's backbone features from :func:`make_feature_fn`) and
    ``labels_all`` ((M, N)) on the device, so an epoch moves no pixels.
    Loss, gradient and confusion matrix are the frozen train step's, ragged
    tail mask included, and ``opt_state`` is ``init_opt_state(...,
    freeze_backbone=True)``'s, so resume files serve both paths.  Float32
    features run with TF32 off."""
    if head_type == "moe":
        raise NotImplementedError(_roadmap("the MoE head", 8))

    def step(head, opt_state, feats_all, labels_all, ids, mask=None):
        feats = feats_all.index_select(0, ids)
        y = labels_all.index_select(0, ids).reshape(-1)
        cdt = None if feats.dtype == torch.float32 else feats.dtype
        with matmul_ctx(cdt):
            opt_state.zero_grad(set_to_none=True)
            logp = head_apply(head_type, head,
                              feats.reshape(-1, feats.shape[-1]))
            w = (None if mask is None else mask.to(logp.dtype)
                 .repeat_interleave(y.shape[0] // mask.shape[0]))
            loss = nll_loss(logp, y, w)
            loss.backward()
            opt_state.step()
        return loss.detach(), confusion_matrix(logp.detach().argmax(dim=-1),
                                               y, n_classes, w)
    return step


def make_cached_head_eval_step(head_type: str, n_classes: int) -> Callable:
    """``step(head, feats_all, labels_all) -> cm`` over the whole cached
    feature set in one call, no gradient."""
    @torch.no_grad()
    def step(head, feats_all, labels_all):
        cdt = None if feats_all.dtype == torch.float32 else feats_all.dtype
        with matmul_ctx(cdt):
            logp = head_apply(head_type, head,
                              feats_all.reshape(-1, feats_all.shape[-1]))
        return confusion_matrix(logp.argmax(dim=-1), labels_all.reshape(-1),
                                n_classes)
    return step
