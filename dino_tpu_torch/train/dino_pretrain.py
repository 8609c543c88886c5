"""DINO self-supervised pretraining: the port of
``dino_tpu/train/dino_pretrain.py``.

A student (ViT + DINO head) learns to match an EMA teacher's centred and
sharpened distributions across multi-crop views (2 global + N local),
same-view pairs excluded.  The step:

  * normalizes uint8 crops on the model's device, each tensor on its own
    (float crops pass through, pre-normalized);
  * runs the student over every view (one backbone pass per resolution
    group, :func:`multi_crop_forward`) and the teacher over the global
    views with no gradient; on the card both forwards take the flash
    kernels, and the student's backward the flash backward;
  * with ``accum_steps=K`` runs K microbatches (rows [k*mb, (k+1)*mb) of
    every view), sums their gradients and divides by K, and centres on the
    full-batch teacher mean;
  * clips each parameter's gradient on its own (:func:`clip_gradients`),
    multiplies the last layer's by 1 - ``freeze_last``, makes one
    optimizer update, the EMA of the teacher and of the centre.

PyTorch updates in place: the step changes the student, the teacher, the
centre and the optimizer's state, and returns the loss.  Every parameter
of the student reaches the optimizer with a gradient (zeros where the loss
gives none, as the head's ``g`` under ``norm_last_layer``): ``torch.optim``
skips a parameter whose ``.grad`` is None, where optax's AdamW still takes
its weight decay and moment step.

The optimizer is ``torch.optim.AdamW`` (:func:`make_dino_optimizer`), its
``lr`` and ``weight_decay`` set on every step from the host schedules
(:func:`set_hyperparams`), the counterpart of the CLI's
``optax.inject_hyperparams(adamw)``.  optax adds wd * p to the update
before scaling by lr; torch multiplies p by (1 - lr * wd) first: the same
step up to one rounding.

The host side draws every crop's randomness in Python from a numpy
Generator (:func:`draw_dino_params`) and makes the pixels with the native
loader (``data/native_loader.py:dino_crops_batch``) where it builds, else
with cv2 (:func:`apply_dino_crop`), as ``dino_tpu`` does.

Over ranks (``dp_group``): every rank runs its equal slab of the global
batch; the gradients, the loss and the teacher's batch mean are summed over
the ranks and divided by their count, so the step is the global batch's
(the mean of equal slabs' means).  ``fsdp_mesh``: the student, the teacher
and the optimizer's moments live in FSDP's units over the ranks
(:func:`shard_dino_state`, :func:`dino_units`: the embeddings with the
final norm, each block, the head's MLP, its last layer).  Both forwards
gather one unit at a time (a unit runs every microbatch's resolution
groups while gathered, the teacher's under ``no_grad``), one backward
follows, and each student unit's recomputes it microbatch by microbatch
and reduce-scatters the sum once; the step clips each leaf by its norm
over every shard (the squared norms summed over the ranks) and runs AdamW
and the teacher's EMA on the shards.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from dino_tpu_torch.models.dino_head import (DINOHead, crop_groups,
                                             dino_head_last, dino_head_mlp,
                                             init_dino_head,
                                             multi_crop_forward)
from dino_tpu_torch.models.vit import (ViTConfig, VisionTransformer,
                                       init_vit_params, vit_forward,
                                       vit_forward_units, vit_units)
from dino_tpu_torch.ops.preprocess import normalize_imagenet
from dino_tpu_torch.parallel.dist import all_reduce_sum_, get_world_size
from dino_tpu_torch.parallel.mesh import (FSDPOptimizer, gradient_norms,
                                          optimizer_params, run_unit)
from dino_tpu_torch.precision import matmul_ctx
from dino_tpu_torch.train.optim import clip_gradients, get_params_groups
from dino_tpu_torch.utils.device import resolve_device
from dino_tpu_torch.utils.schedules import cosine_scheduler


@dataclasses.dataclass(frozen=True)
class DinoConfig:
    out_dim: int = 65536
    student_temp: float = 0.1
    center_momentum: float = 0.9
    n_local_crops: int = 8
    global_size: int = 224
    local_size: int = 96
    norm_last_layer: bool = True
    hidden_dim: int = 2048
    bottleneck_dim: int = 256


class DinoModel(nn.Module):
    """A student or a teacher: ``vit`` (the backbone) and ``head``."""

    def __init__(self, vit_cfg: ViTConfig, dino_cfg: DinoConfig,
                 depth: Optional[int] = None):
        super().__init__()
        self.vit = VisionTransformer(vit_cfg, depth=depth)
        self.head = DINOHead(vit_cfg.embed_dim, dino_cfg.out_dim,
                             norm_last_layer=dino_cfg.norm_last_layer,
                             hidden_dim=dino_cfg.hidden_dim,
                             bottleneck_dim=dino_cfg.bottleneck_dim)


def init_dino_params(generator: torch.Generator, vit_cfg: ViTConfig,
                     dino_cfg: DinoConfig, depth: Optional[int] = None,
                     device=None) -> Tuple[DinoModel, DinoModel]:
    """(student, teacher) on ``device`` (the card unless ``'cpu'`` is
    asked for); the teacher is a copy of the student, not an alias, with
    no gradient.  Weights are drawn from ``generator`` on the CPU."""
    student = DinoModel(vit_cfg, dino_cfg, depth)
    init_vit_params(student.vit, generator)
    init_dino_head(student.head, generator)
    return dino_pair(student, device)


def dino_pair(student: DinoModel, device=None) -> Tuple[DinoModel,
                                                       DinoModel]:
    """``student`` on ``device`` and its teacher, a copy with no
    gradient."""
    student = student.to(resolve_device(device))
    teacher = copy.deepcopy(student).requires_grad_(False)
    return student, teacher


def dino_loss(student_out: torch.Tensor, teacher_out: torch.Tensor,
              center: torch.Tensor, student_temp: float, teacher_temp,
              n_crops: int, n_global: int = 2) -> torch.Tensor:
    """Cross-entropy between the centred, sharpened teacher distributions
    (global views) and the student's log-probabilities (every view),
    same-view pairs skipped, averaged over the pairs.  Softmax and
    log_softmax in float32.  ``student_out`` (n_crops*B, K),
    ``teacher_out`` (n_global*B, K)."""
    b = student_out.shape[0] // n_crops
    s = torch.log_softmax((student_out / student_temp).float(), dim=-1)
    s = s.reshape(n_crops, b, -1)
    t = torch.softmax(((teacher_out - center) / teacher_temp).float(), dim=-1)
    t = t.reshape(n_global, b, -1).detach()
    total, n_terms = 0.0, 0
    for iq in range(n_global):
        for v in range(n_crops):
            if v == iq:
                continue
            total = total + torch.sum(-t[iq] * s[v], dim=-1).mean()
            n_terms += 1
    return total / n_terms


def center_ema(center: torch.Tensor, batch_center: torch.Tensor,
               momentum: float) -> torch.Tensor:
    """EMA of the centre toward a full-batch teacher mean."""
    return center * momentum + batch_center * (1.0 - momentum)


def update_center(center: torch.Tensor, teacher_out: torch.Tensor,
                  momentum: float) -> torch.Tensor:
    """EMA of the teacher's batch mean (the centring against collapse)."""
    batch_center = teacher_out.float().mean(dim=0, keepdim=True)
    return center_ema(center, batch_center, momentum)


@torch.no_grad()
def ema_update(teacher: nn.Module, student: nn.Module, momentum) -> None:
    """teacher <- m * teacher + (1 - m) * student, in place, over every
    floating-point tensor of the state (float32, as the port's masters;
    others are left as they are).  ``momentum`` is rounded to float32
    first and 1 - m is taken in float32, as ``dino_tpu``'s traced
    scalar."""
    m = np.float32(momentum)
    one_m = np.float32(1.0) - m
    pairs = [(t, s) for t, s in zip(teacher.state_dict().values(),
                                    student.state_dict().values())
             if t.is_floating_point()]
    if any(t.dtype != torch.float32 for t, _ in pairs):
        raise TypeError("ema_update takes float32 teacher tensors")
    ts = [t for t, _ in pairs]
    torch._foreach_mul_(ts, float(m))
    torch._foreach_add_(ts, torch._foreach_mul([s.float() for _, s in pairs],
                                               float(one_m)))


def dino_units(model: DinoModel):
    """FSDP's units of a student or teacher: the ViT's
    (:func:`~dino_tpu_torch.models.vit.vit_units`), the head's MLP and its
    weight-normed last layer."""
    return vit_units(model.vit) + [
        ("head.mlp", list(model.head.mlp.parameters())),
        ("head.last_layer", list(model.head.last_layer.parameters()))]


def shard_dino_state(student: DinoModel, teacher: DinoModel,
                     opt: torch.optim.Optimizer, group,
                     device=None) -> FSDPOptimizer:
    """FSDP of the pretrain state over ``group``, before the first step:
    the student's parameters in :func:`dino_units`, ``opt``
    (:func:`make_dino_optimizer`'s, no step taken yet) moved onto their
    pieces, the teacher's units sharded alongside as followers; the
    shards on ``device`` (default: the parameters'; build both models on
    the host and only the shards reach the card), both models' full
    tensors dropped.  Pass the result as the step's ``opt_state`` with
    ``fsdp_mesh=group``; ``to_host()`` binds both models to whole host
    tensors for a save (a collective)."""
    if any(b.is_floating_point() for m in (student, teacher)
           for b in m.buffers()):
        raise TypeError("FSDP of the pretrain state shards parameters only")
    return FSDPOptimizer(opt, group, dino_units(student),
                         followers=dino_units(teacher), device=device)


@torch.no_grad()
def _ema_shards(opt_state: FSDPOptimizer, momentum) -> None:
    """:func:`ema_update` on the shards, unit for unit: the same
    elementwise math."""
    m = np.float32(momentum)
    one_m = np.float32(1.0) - m
    t_shards = [u.shard for u in opt_state.followers]
    s_shards = [u.shard for u in opt_state.units]
    torch._foreach_mul_(t_shards, float(m))
    torch._foreach_add_(t_shards, torch._foreach_mul(s_shards, float(one_m)))


def dino_forward(model: DinoModel, crops: Sequence[torch.Tensor],
                 vit_cfg: ViTConfig,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Normalized crops -> (n_views * B, out_dim) float32 logits: the
    backbone's CLS feature per resolution group, then the head."""
    def backbone(batch):
        x = batch.to(compute_dtype) if compute_dtype is not None else batch
        return vit_forward(model.vit, x, vit_cfg, all_tokens=False)

    return multi_crop_forward(backbone, model.head, crops)


def dino_forward_units(model: DinoModel,
                       chunks: Sequence[Sequence[torch.Tensor]],
                       vit_cfg: ViTConfig, fsdp: FSDPOptimizer,
                       compute_dtype: Optional[torch.dtype] = None
                       ) -> List[torch.Tensor]:
    """:func:`dino_forward` of each microbatch's crops in ``chunks`` under
    FSDP (``fsdp`` holding the model's :func:`dino_units`): one unit
    gathered at a time, running every microbatch's resolution groups."""
    groups = [[g.to(compute_dtype) if compute_dtype is not None else g
               for g in crop_groups(crops)] for crops in chunks]
    feats = [(torch.cat(f, dim=0),) for f in vit_forward_units(
        model.vit, groups, vit_cfg, fsdp, all_tokens=False)]
    h = run_unit(fsdp.unit_of(model.head.mlp),
                 lambda x: dino_head_mlp(model.head, x), feats)
    return [out for (out,) in run_unit(
        fsdp.unit_of(model.head.last_layer),
        lambda x: dino_head_last(model.head, x), h)]


def make_dino_optimizer(student: DinoModel, lr: float = 5e-4,
                        weight_decay: float = 0.04, masked: bool = True
                        ) -> torch.optim.AdamW:
    """AdamW (b1 .9, b2 .999, eps 1e-8, optax's defaults) over the
    student.  ``masked`` decays only parameters of 2 or more dimensions
    (:func:`get_params_groups`, the CLI's ``wd_mask``); unmasked decays
    every parameter, as optax's ``adamw`` with no mask.  Fused on the
    card."""
    if masked:
        groups = get_params_groups(student)
        groups[0]["decayed"], groups[1]["decayed"] = True, False
    else:
        groups = [{"params": list(student.parameters()), "decayed": True}]
    on_card = all(p.is_cuda for g in groups for p in g["params"])
    return torch.optim.AdamW(groups, lr=lr, weight_decay=weight_decay,
                             betas=(0.9, 0.999), eps=1e-8,
                             fused=True if on_card else None)


def set_hyperparams(opt: torch.optim.Optimizer, lr: float,
                    weight_decay: float) -> None:
    """This step's learning rate (every group) and weight decay (the
    decayed groups)."""
    for group in opt.param_groups:
        group["lr"] = lr
        if group.get("decayed", True):
            group["weight_decay"] = weight_decay


def make_dino_train_step(vit_cfg: ViTConfig, dino_cfg: DinoConfig,
                         compute_dtype: Optional[torch.dtype] = None,
                         clip: float = 3.0, accum_steps: int = 1,
                         fsdp_mesh=None, dp_group=None) -> Callable:
    """Returns ``step(student, teacher, center, opt_state, g_crops,
    l_crops, teacher_temp, ema_momentum, freeze_last) -> loss``.

    ``g_crops`` (2, B, G, G, 3) and ``l_crops`` (n_local, B, l, l, 3),
    uint8 or pre-normalized float, lie on the models' device, as ``center``
    (1, out_dim) float32 does; ``opt_state`` is :func:`make_dino_optimizer`'s
    over the student; the three scalars are host floats.  The step updates
    ``student``, ``teacher``, ``center`` and ``opt_state`` in place and
    leaves the clipped gradients in the student's ``.grad``; it returns the
    loss, a 0-dim float32 tensor on the device.  ``compute_dtype=None`` is
    true float32 (TF32 off inside the step); ``torch.bfloat16`` runs the
    backbones in bf16.  The batch must divide by ``accum_steps``.

    ``dp_group`` (more than one rank): each rank passes its slab of the
    global batch, the same size on every rank; gradients, loss and the
    teacher's batch mean are averaged over the group.  ``fsdp_mesh``:
    ``opt_state`` is :func:`shard_dino_state`'s over that group (and
    ``dp_group``, if given, is the same group); the clipped gradients are
    then left in the units' shard gradients."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    n_crops = 2 + dino_cfg.n_local_crops
    dp = (dp_group if dp_group is not None and get_world_size(dp_group) > 1
          else None)

    def loss_of(s_out, t_out, center, teacher_temp):
        return dino_loss(s_out, t_out, center, dino_cfg.student_temp,
                         teacher_temp, n_crops)

    def microbatches(g, l, k, mb):
        """Each microbatch's (student crops, teacher crops)."""
        out = []
        for i in range(k):
            gi, li = g[:, i * mb:(i + 1) * mb], l[:, i * mb:(i + 1) * mb]
            out.append(([gi[0], gi[1]] + list(li.unbind(0)), [gi[0], gi[1]]))
        return out

    def step(student, teacher, center, opt_state, g_crops, l_crops,
             teacher_temp, ema_momentum, freeze_last):
        b = g_crops.shape[1]
        if b % accum_steps:
            raise ValueError(
                f"batch {b} must divide by accum_steps={accum_steps} "
                f"(microbatches are equal-sized)")
        if g_crops.dtype == torch.uint8:
            g_crops = normalize_imagenet(g_crops)
        if l_crops.dtype == torch.uint8:
            l_crops = normalize_imagenet(l_crops)
        teacher_temp = float(np.float32(teacher_temp))
        fs = opt_state if isinstance(opt_state, FSDPOptimizer) else None
        if fsdp_mesh is not None and not (fs is not None
                                          and fs.group is fsdp_mesh):
            raise TypeError("fsdp_mesh needs opt_state from "
                            "shard_dino_state(..., group=fsdp_mesh)")
        if fs is not None:  # a rank's slab, or every rank the whole batch
            if dp is not None and dp is not fs.group:
                raise ValueError("FSDP reduces each unit's gradient over "
                                 "fsdp_mesh: pass the same group as "
                                 "dp_group")
            fs.book.sum_ranks = dp is not None
        params = optimizer_params(opt_state)
        k, mb = accum_steps, b // accum_steps
        with matmul_ctx(compute_dtype):
            opt_state.zero_grad(set_to_none=True)
            loss_sum, t_sum = 0.0, 0.0
            mbs = microbatches(g_crops, l_crops, k, mb)
            if fs is None:
                for s_crops, t_crops in mbs:
                    s_out = dino_forward(student, s_crops, vit_cfg,
                                         compute_dtype)
                    with torch.no_grad():
                        t_out = dino_forward(teacher, t_crops, vit_cfg,
                                             compute_dtype)
                    loss = loss_of(s_out, t_out, center, teacher_temp)
                    loss.backward()
                    loss_sum = loss_sum + loss.detach()
                    t_sum = t_sum + t_out.float().mean(dim=0)
            else:  # every microbatch through one unit at a time
                s_outs = dino_forward_units(student, [c for c, _ in mbs],
                                            vit_cfg, fs, compute_dtype)
                with torch.no_grad():
                    t_outs = dino_forward_units(teacher, [c for _, c in mbs],
                                                vit_cfg, fs, compute_dtype)
                total = 0
                for s_out, t_out in zip(s_outs, t_outs):
                    loss = loss_of(s_out, t_out, center, teacher_temp)
                    total = total + loss
                    loss_sum = loss_sum + loss.detach()
                    t_sum = t_sum + t_out.float().mean(dim=0)
                total.backward()
            t_mean = t_sum / k
            loss = loss_sum / k
            last = student.head.last_layer
            if fs is None:
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                grads = [p.grad for p in params]
                if k > 1:
                    torch._foreach_div_(grads, float(k))
                if dp is not None:  # the global batch: the slabs' mean
                    n = float(get_world_size(dp))
                    all_reduce_sum_(grads + [t_mean, loss], dp)
                    torch._foreach_div_(grads, n)
                    t_mean, loss = t_mean / n, loss / n
                norms, last_grads = None, [last.v.grad, last.g.grad]
            else:  # the units' backwards summed the slabs' gradients
                grads = fs.shard_grads()
                unit_grads = fs.unit_grads()
                if k > 1:
                    torch._foreach_div_(unit_grads, float(k))
                if dp is not None:
                    n = float(get_world_size(dp))
                    all_reduce_sum_([t_mean, loss], dp)
                    torch._foreach_div_(unit_grads, n)
                    t_mean, loss = t_mean / n, loss / n
                # the clip and the update run on the shards
                norms = gradient_norms(grads, fs.group)
                last_grads = [fs.piece_of(p).grad for p in (last.v, last.g)]
            clip_gradients(grads, clip, norms)
            torch._foreach_mul_(last_grads, 1.0 - float(freeze_last))
            opt_state.step()
        if fs is not None:
            _ema_shards(fs, ema_momentum)
        else:
            ema_update(teacher, student, ema_momentum)
        with torch.no_grad():
            center.copy_(center_ema(center, t_mean[None],
                                    dino_cfg.center_momentum))
        return loss

    return step


# ---------------------------------------------------------------------------
# Host-side multi-crop augmentation (DataAugmentationDINO's distributions).
# The randomness is drawn in Python (draw_dino_params) and the pixels are
# made by the cv2 path (apply_dino_crop) or the native loader, so the
# parameter stream does not depend on the pixel backend.
# ---------------------------------------------------------------------------

def _blur_sigma(img: np.ndarray, radius: float) -> np.ndarray:
    """GaussianBlur with an explicit sigma, the kernel size from it."""
    import cv2
    k = max(3, int(radius * 4) | 1)
    return cv2.GaussianBlur(img, (k, k), sigmaX=radius)


def _rrc_rect(rng: np.random.Generator, h: int, w: int, scale):
    """RandomResizedCrop rectangle (y0, x0, ch, cw): torchvision's sampling,
    10 area/aspect attempts, then the whole image."""
    area = h * w
    for _ in range(10):
        ta = area * rng.uniform(*scale)
        aspect = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(ta * aspect)))
        ch = int(round(np.sqrt(ta / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            return (y0, x0, ch, cw)
    return (0, 0, h, w)


def draw_dino_params(rng: np.random.Generator, h: int, w: int,
                     cfg: DinoConfig) -> List[dict]:
    """All randomness of one image's multi-crop as plain parameters, 2 +
    n_local dicts (globals first).  Global RandomResizedCrop scale (0.4, 1),
    local (0.05, 0.4); flip .5; jitter .8; grayscale .2; blur 1.0 / 0.1 on
    the globals and .5 on the locals; solarization .2 on global 2."""
    def base(size, scale):
        p = {"size": size, "rect": _rrc_rect(rng, h, w, scale),
             "flip": rng.random() < 0.5, "jitter": None, "gray": False,
             "blur_sigma": None, "solarize": False}
        if rng.random() < 0.8:  # ColorJitter(.4, .4, .2, .1)
            factors = (rng.uniform(0.6, 1.4), rng.uniform(0.6, 1.4),
                       rng.uniform(0.8, 1.2), rng.uniform(-0.1, 0.1))
            p["jitter"] = (rng.permutation(4), factors)
        if rng.random() < 0.2:
            p["gray"] = True
        return p

    g1 = base(cfg.global_size, (0.4, 1.0))
    g1["blur_sigma"] = rng.uniform(0.1, 2.0)
    g2 = base(cfg.global_size, (0.4, 1.0))
    if rng.random() < 0.1:
        g2["blur_sigma"] = rng.uniform(0.1, 2.0)
    if rng.random() < 0.2:
        g2["solarize"] = True
    crops = [g1, g2]
    for _ in range(cfg.n_local_crops):
        lc = base(cfg.local_size, (0.05, 0.4))
        if rng.random() < 0.5:
            lc["blur_sigma"] = rng.uniform(0.1, 2.0)
        crops.append(lc)
    return crops


def apply_dino_crop(img: np.ndarray, p: dict) -> np.ndarray:
    """The cv2 pixel path of one drawn crop (the native loader's oracle):
    crop, INTER_CUBIC resize, flip, the jitter recipe of
    ``data/augment.py``, grayscale, blur, solarization."""
    import cv2

    from dino_tpu_torch.data.augment import _apply_jitter
    y0, x0, ch, cw = p["rect"]
    out = cv2.resize(img[y0:y0 + ch, x0:x0 + cw], (p["size"], p["size"]),
                     interpolation=cv2.INTER_CUBIC)
    if p["flip"]:
        out = out[:, ::-1].copy()
    if p["jitter"] is not None:
        order, factors = p["jitter"]
        out = _apply_jitter(out, order, factors)
    if p["gray"]:
        g = cv2.cvtColor(out, cv2.COLOR_RGB2GRAY)
        out = np.repeat(g[..., None], 3, axis=-1)
    if p["blur_sigma"] is not None:
        out = _blur_sigma(out, p["blur_sigma"])
    if p["solarize"]:
        out = np.where(out >= 128, 255 - out.astype(np.int16), out).astype(
            np.uint8)
    return out


def pack_dino_params(crops: List[dict]) -> np.ndarray:
    """Parameter dicts -> the float32 (n_crops, 20) rows the native loader
    reads (``native/dtloader.cpp`` dino_crop_one)."""
    out = np.zeros((len(crops), 20), np.float32)
    for i, p in enumerate(crops):
        out[i, 0:4] = p["rect"]
        out[i, 4] = p["flip"]
        if p["jitter"] is not None:
            order, (fb, fc, fs, fh) = p["jitter"]
            out[i, 5] = 1
            out[i, 6:10] = np.asarray(order, np.float32)
            out[i, 10:14] = (fb, fc, fs, fh)
        out[i, 14] = p["gray"]
        if p["blur_sigma"] is not None:
            r = p["blur_sigma"]
            out[i, 15] = 1
            out[i, 16] = max(3, int(r * 4) | 1)
            out[i, 17] = r
        out[i, 18] = p["solarize"]
        out[i, 19] = p["size"]
    return out


def dino_multi_crop(rng: np.random.Generator, img: np.ndarray,
                    cfg: DinoConfig):
    """One image -> (2 global crops, n_local local crops), uint8 HWC, by
    the cv2 path."""
    crops = [apply_dino_crop(img, p)
             for p in draw_dino_params(rng, *img.shape[:2], cfg)]
    return crops[:2], crops[2:]


def dino_multi_crop_batch(paths, rngs, cfg: DinoConfig):
    """A batch of image files -> (g_crops (2, n, G, G, 3), l_crops (L, n,
    l, l, 3)) uint8.  The pixels come from the native loader (each JPEG
    decoded once, every crop off the GIL) where it builds, else from the
    cv2 path; the parameters are drawn in Python either way, one rng per
    image."""
    from PIL import Image

    from dino_tpu_torch.data import native_loader
    sizes = []
    for f in paths:
        with Image.open(f) as im:  # the header only
            sizes.append((im.height, im.width))
    params = [draw_dino_params(rng, h, w, cfg)
              for rng, (h, w) in zip(rngs, sizes)]
    packed = np.stack([pack_dino_params(c) for c in params])
    native = native_loader.dino_crops_batch(
        [str(p) for p in paths], packed, cfg.n_local_crops, cfg.global_size,
        cfg.local_size)
    if native is not None:
        return native
    gs, ls = [], []
    for f, crops in zip(paths, params):
        with Image.open(f) as im:
            img = np.array(im.convert("RGB"))
        outs = [apply_dino_crop(img, p) for p in crops]
        gs.append(outs[:2])
        ls.append(outs[2:])
    g = np.stack([np.stack([x[c] for x in gs]) for c in range(2)])
    l = np.stack([np.stack([x[c] for x in ls])
                  for c in range(cfg.n_local_crops)])
    return g, l


def dino_schedules(base_lr: float, epochs: int, niter_per_ep: int,
                   warmup_epochs: int = 10, final_lr: float = 1e-6,
                   momentum_base: float = 0.996,
                   teacher_temp: float = 0.04,
                   warmup_teacher_temp: float = 0.04,
                   warmup_teacher_temp_epochs: int = 0,
                   wd_base: float = 0.04, wd_final: float = 0.4):
    """The recipe's four per-iteration schedules: (lr, weight decay, teacher
    EMA momentum, teacher temperature)."""
    lr = cosine_scheduler(base_lr, final_lr, epochs, niter_per_ep,
                          warmup_epochs=min(warmup_epochs, epochs))
    wd = cosine_scheduler(wd_base, wd_final, epochs, niter_per_ep)
    momentum = cosine_scheduler(momentum_base, 1.0, epochs, niter_per_ep)
    warm = np.linspace(warmup_teacher_temp, teacher_temp,
                       warmup_teacher_temp_epochs * niter_per_ep)
    rest = np.full(max(0, (epochs - warmup_teacher_temp_epochs)
                       * niter_per_ep), teacher_temp)
    t_temp = np.concatenate([warm, rest])[:epochs * niter_per_ep]
    return lr, wd, momentum, t_temp
