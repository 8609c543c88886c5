"""The segmentation forward, train step, eval step and feature function.

The counterpart of ``dino_tpu/train/loop.py`` for the ViT and the cnn1/cnn2
ResNet backbones with the MLP, linear or MoE head:

  * ``make_optimizer``: torch-default Adam / AdamW / SGD (``torch.optim``,
    fused on the card), the hyperparameters of the JAX package's optax
    transforms; AdamW decays every parameter, as optax's unmasked ``adamw``;
  * ``make_train_step``: frozen backbone (run under ``torch.no_grad()``, the
    counterpart of ``stop_gradient``; only the head trains) or unfrozen
    (backbone and head train, attention through the flash backward), with
    ``accum_steps`` microbatches summed into one optimizer update;
  * the MoE head adds 0.01 x the router's load-balance term; with
    microbatches a forward-only pass first gives the full batch's routing
    fractions, so the accumulated step equals the monolithic one;
  * a ResNet backbone runs BatchNorm in train mode inside the step (batch
    statistics, frozen or not) and its running stats are written back
    after the update;
  * uint8 batches are normalized on the device inside the step, and the
    step returns the loss and an on-device confusion matrix.

PyTorch updates in place: the step changes the modules' parameters and the
optimizer's state instead of returning new ones.

Over ranks (``dp_group``, one process per card): each rank runs its slab of
the global batch, the gradients, the loss, the confusion matrix and the
weight total are summed over the ranks before the one division by the
global weight total, and every rank makes the same update.  ZeRO-1
(``zero_mesh``) takes a ``parallel/mesh.py:ShardedOptimizer`` over that
group, FSDP (``fsdp_mesh``) a ``parallel/mesh.py:FSDPOptimizer``
(:func:`init_opt_state`'s ``zero_mesh`` / ``fsdp_mesh``): the ViT runs one
unit (a block; the embeddings with the final norm; the head) gathered at a
time (:func:`seg_forward_units`), each unit's backward recomputes it and
reduce-scatters its gradient, and the step updates the shards.

Tensor parallelism (``tp_group``, DP x TP on a ``parallel/mesh.py:
make_grid`` grid): the backbone is this rank's Megatron shard
(``parallel/tp.py:tp_shard_vit``) and its blocks run ``tp_block_apply`` over
the model group; ``dp_group`` is then the data group, and ZeRO-1 shards each
rank's tensor-parallel slice over it.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch
from torch.distributed import ProcessGroup

from dino_tpu_torch.models.heads import (head_apply, moe_balance_loss,
                                         moe_balance_stats)
from dino_tpu_torch.models.resnet import resnet_features, update_bn_stats
from dino_tpu_torch.models.vit import (ViTConfig, VisionTransformer,
                                       vit_forward, vit_forward_units,
                                       vit_units)
from dino_tpu_torch.ops.preprocess import normalize_imagenet
from dino_tpu_torch.parallel.dist import (all_reduce_sum_, get_rank,
                                          get_world_size)
from dino_tpu_torch.parallel.mesh import (FSDPOptimizer, ShardedOptimizer,
                                          optimizer_params, run_unit)
from dino_tpu_torch.parallel.tp import TPVisionTransformer, vit_forward_tp
from dino_tpu_torch.precision import matmul_ctx
from dino_tpu_torch.train.metrics import confusion_matrix

# tokens per (micro)batch above which the unfrozen step recomputes block
# activations in the backward pass (dino_tpu/train/loop.py:172)
REMAT_TOKENS = 200_000
# weight of the MoE router's load-balance term in the train loss
MOE_BALANCE_COEF = 0.01

Optimizer = Callable[[list], torch.optim.Optimizer]


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


def seg_units(vit: VisionTransformer, head: torch.nn.Module):
    """FSDP's units of the segmentation model: the ViT's
    (:func:`~dino_tpu_torch.models.vit.vit_units`) and the head."""
    return vit_units(vit) + [("head", list(head.parameters()))]


def init_opt_state(optimizer: Optimizer, vit: VisionTransformer,
                   head: torch.nn.Module, freeze_backbone: bool,
                   zero_mesh=None, fsdp_mesh=None):
    """The optimizer over the head, or over the head and the backbone.
    ``zero_mesh`` (a process group) moves it onto ZeRO-1's shards
    (``parallel/mesh.py:ShardedOptimizer``); ``fsdp_mesh`` moves the
    unfrozen ViT and the head into FSDP's units over that group
    (``parallel/mesh.py:FSDPOptimizer``, :func:`seg_units`), their shards
    on the parameters' device, the full parameters dropped."""
    params = list(head.parameters())
    if not freeze_backbone:
        params += list(vit.parameters())
    if zero_mesh is not None and fsdp_mesh is not None:
        raise ValueError("fsdp_mesh and zero_mesh are mutually exclusive: "
                         "FSDP already shards the optimizer state")
    if fsdp_mesh is not None:
        _check_fsdp(not freeze_backbone and type(vit) is VisionTransformer)
    opt = optimizer(params)
    if fsdp_mesh is not None:
        return FSDPOptimizer(opt, fsdp_mesh, seg_units(vit, head))
    if zero_mesh is not None:
        opt = ShardedOptimizer(opt, zero_mesh)
    return opt


def _check_fsdp(unfrozen_vit: bool) -> None:
    if not unfrozen_vit:
        raise ValueError("FSDP shards the train state of an unfrozen ViT "
                         "backbone (not a frozen one, a ResNet or a "
                         "tensor-parallel shard)")


def _check_group(name: str, group) -> None:
    if group is not None and not isinstance(group, ProcessGroup):
        raise TypeError(f"{name} takes a torch.distributed process group "
                        f"(dist.group.WORLD for the default one), got "
                        f"{type(group).__name__}")


def backbone_features(vit: torch.nn.Module, x: torch.Tensor, cfg: ViTConfig,
                      backbone: str = "vit", remat: bool = False,
                      bn_collect: Optional[dict] = None,
                      bn_group=None, tp_group=None) -> torch.Tensor:
    """Normalized (B, H, W, 3) -> (B*N_patches, D) patch features: the ViT's
    tokens without its prefix (CLS, and a DINOv3 model's storage tokens),
    or a ResNet's (B, H/8, W/8, 512) map in row-major
    order (``bn_collect`` switches its BatchNorm to train mode, with batch
    statistics over ``bn_group``'s ranks' slabs too).  A
    :class:`~dino_tpu_torch.parallel.tp.TPVisionTransformer` runs
    tensor-parallel over ``tp_group``."""
    if backbone != "vit":
        return resnet_features(vit, x, bn_collect, bn_group)
    if isinstance(vit, TPVisionTransformer):
        tokens = vit_forward_tp(vit, x, cfg, tp_group, remat=remat)
        return tokens[:, 1:, :].reshape(-1, tokens.shape[-1])
    tokens = vit_forward(vit, x, cfg, remat=remat)
    return tokens[:, cfg.num_prefix:, :].reshape(-1, tokens.shape[-1])


def seg_forward(vit: torch.nn.Module, head: torch.nn.Module, cfg: ViTConfig,
                head_type: str, images_u8: Optional[torch.Tensor] = None,
                pre_normalized: Optional[torch.Tensor] = None,
                compute_dtype: Optional[torch.dtype] = None,
                remat: bool = False,
                freeze_backbone: bool = False, backbone: str = "vit",
                bn_collect: Optional[dict] = None,
                feat_sink: Optional[dict] = None,
                moe_dispatch: str = "dense",
                moe_capacity: float = 1.25, bn_group=None,
                tp_group=None) -> torch.Tensor:
    """uint8 (B,res,res,3) -> (B*N_patches, n_classes) log-probs.

    Backbone -> (ViT: drop CLS and any storage tokens) -> fold patches
    onto the batch axis ->
    per-patch head.  Normalization runs here unless a pre-normalized tensor
    is given (the predict path resizes and normalizes upstream).
    ``compute_dtype=torch.bfloat16`` runs the matmuls in bf16; LayerNorm,
    softmax and the final log_softmax stay float32.  ``freeze_backbone``
    runs the backbone under ``torch.no_grad()``; ``remat`` recomputes the
    ViT's blocks in the backward pass.  ``bn_collect`` (a dict) runs a
    ResNet's BatchNorm in train mode and collects its running stats (the
    batch statistics summed over ``bn_group``'s ranks, if given);
    ``feat_sink`` (a dict) receives the head's input features under
    ``"feats"`` (the MoE balance term's input).  ``tp_group``: the model
    group of a tensor-parallel backbone.
    """
    x = (pre_normalized if pre_normalized is not None
         else normalize_imagenet(images_u8))
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and not freeze_backbone):
        feats = backbone_features(vit, x, cfg, backbone, remat, bn_collect,
                                  bn_group, tp_group)
    if feat_sink is not None:
        feat_sink["feats"] = feats
    return head_apply(head_type, head, feats, moe_dispatch, moe_capacity)


def unit_features(fsdp: FSDPOptimizer, vit: VisionTransformer,
                  xs: List[torch.Tensor], cfg: ViTConfig
                  ) -> List[torch.Tensor]:
    """:func:`backbone_features` of a ViT for each microbatch of ``xs``
    under FSDP, one unit gathered at a time."""
    out = []
    for (tokens,) in vit_forward_units(vit, [[x] for x in xs], cfg, fsdp):
        out.append(tokens[:, cfg.num_prefix:, :].reshape(-1,
                                                         tokens.shape[-1]))
    return out


def seg_forward_units(fsdp: FSDPOptimizer, vit: VisionTransformer,
                      head: torch.nn.Module, cfg: ViTConfig, head_type: str,
                      images_u8: List[torch.Tensor],
                      compute_dtype: Optional[torch.dtype] = None,
                      extra: Optional[Callable] = None,
                      aux: Optional[List[tuple]] = None,
                      moe_dispatch: str = "dense",
                      moe_capacity: float = 1.25) -> List[tuple]:
    """:func:`seg_forward` of each microbatch of ``images_u8`` under FSDP
    (``fsdp`` an ``FSDPOptimizer`` over :func:`seg_units`): the ViT through
    ``vit_forward_units``, then the head as one unit.  Returns per
    microbatch (log-probs,), or with ``extra`` (log-probs, ``extra(head,
    feats, *aux[i])``): a term of the head's parameters, run inside its
    unit, over the microbatch's tensors ``aux[i]``."""
    xs = [normalize_imagenet(x) for x in images_u8]
    if compute_dtype is not None:
        xs = [x.to(compute_dtype) for x in xs]
    feats = unit_features(fsdp, vit, xs, cfg)

    def head_fn(f, *a):
        logp = head_apply(head_type, head, f, moe_dispatch, moe_capacity)
        return logp if extra is None else (logp, extra(head, f, *a))
    return run_unit(fsdp.unit_of(head), head_fn,
                    [(f, *a) for f, a in zip(feats, aux or [()] * len(xs))])


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
                    zero_mesh=None, fsdp_mesh=None, dp_group=None,
                    moe_dispatch: str = "dense",
                    moe_capacity: float = 1.25, tp_group=None) -> Callable:
    """Returns ``step(vit, head, opt_state, images_u8, labels, mask=None)
    -> (loss, cm)``, which updates ``vit``/``head`` and ``opt_state`` (from
    :func:`init_opt_state` with the same ``optimizer``) in place.  ``vit``
    is the backbone module: a ViT, or a ResNet for ``backbone='cnn1'`` /
    ``'cnn2'``, whose BatchNorm running stats the step also updates (frozen
    or not, as torch's ``train()``).

    ``images_u8`` (B, res, res, 3) uint8, ``labels`` (B, N_patches) int and
    the optional per-sample 0/1 ``mask`` lie on the model's device; ``loss``
    (0-dim float32) and ``cm`` ((C, C) int64) stay there.  The MoE head
    adds ``MOE_BALANCE_COEF`` x its load-balance term over the real
    patches.

    ``accum_steps=K`` runs forward and backward over K equal microbatches,
    each contributing the SUM of its masked per-patch losses (its gradients
    add up in ``.grad``), divides by the global weight total once after the
    loop and makes one optimizer update: the masked-mean step up to the
    order of float32 sums.  The batch must divide by K.  With the MoE head
    a forward-only pass over the microbatches first gives the full batch's
    routing fractions f (argmax-derived, so gradient-free); each
    microbatch then adds 0.01 * E * <f, sum(gate * w)>, linear in its own
    gate sums, which makes the accumulated balance term and its gradient
    the monolithic step's.  Sparse MoE dispatch and BatchNorm backbones
    cannot split a batch exactly and raise.
    ``compute_dtype=None`` is true float32 (TF32 off inside the step).

    ``dp_group`` (a process group of more than one rank): data
    parallelism.  Each rank passes its slab of the global batch (the same
    size on every rank, padded rows masked out) and the step takes the sum
    form above on it; the gradients, the loss sum, the confusion matrix
    and the weight total are summed over the group, so every rank divides
    the same sums by the global weight total and makes the same update.
    The MoE stats pass sums its routing sums over the group, and a ResNet
    backbone's BatchNorm takes its batch statistics over the global batch.
    ``zero_mesh`` / ``fsdp_mesh``: ``opt_state`` must be
    :func:`init_opt_state`'s over that group: ZeRO-1's moments in shards,
    or FSDP's units (the unfrozen ViT with the mlp, linear or MoE head),
    whose parameters, gradients and moments live in shards.  Under FSDP
    the forward runs every microbatch through one unit gathered at a time
    (:func:`seg_forward_units`; no remat: every unit recomputes its
    forward in its backward), one backward follows, each unit's adding its
    microbatches in the loop's order and reduce-scattering the sum once
    over ``dp_group`` (which must be ``fsdp_mesh``; without it every rank
    runs the whole batch and slices), and the update runs on the shards.

    ``tp_group`` (DP x TP, the model group of ``parallel/mesh.py:make_grid``,
    ``dp_group`` its data group): ``vit`` is this rank's shard
    (``parallel/tp.py:tp_shard_vit(vit, tp_group)``), whose blocks run
    tensor-parallel, and ``opt_state`` is over its parameters.  A slice's
    gradient covers the rank's slice and the whole parameters' are whole
    on every rank of the model group, so the gradients are summed over the
    data group only; with ``zero_mesh`` (the data group) each slice's
    moments shard over it on top of the tensor-parallel split (the
    counterpart of ``dino_tpu``'s ``zero_param_spec``).  The MoE head runs
    whole on every rank (the same function as ``dino_tpu``'s
    expert-sharded one).
    """
    if backbone not in ("vit", "cnn1", "cnn2"):
        raise ValueError(f"unknown backbone {backbone!r}")
    if zero_mesh is not None and fsdp_mesh is not None:
        raise ValueError("fsdp_mesh and zero_mesh are mutually exclusive: "
                         "FSDP already shards the optimizer state")
    for name, group in (("zero_mesh", zero_mesh), ("fsdp_mesh", fsdp_mesh),
                        ("dp_group", dp_group), ("tp_group", tp_group)):
        _check_group(name, group)
    if tp_group is not None and backbone != "vit":
        raise ValueError("tensor parallelism (tp_group) needs the ViT "
                         "backbone")
    if fsdp_mesh is not None:
        _check_fsdp(not freeze_backbone and backbone == "vit"
                    and tp_group is None)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if accum_steps > 1 and head_type == "moe" and moe_dispatch == "sparse":
        raise ValueError("accum_steps>1 with moe_dispatch='sparse' changes "
                         "the capacity semantics (slots are allocated per "
                         "microbatch, not per batch, so different patches "
                         "drop): use the dense dispatch or accum_steps=1")
    if accum_steps > 1 and backbone != "vit":
        raise ValueError("accum_steps>1 needs full-batch BatchNorm "
                         "statistics for cnn backbones: use accum_steps=1")
    dp = (dp_group if dp_group is not None and get_world_size(dp_group) > 1
          else None)
    if dp is not None and head_type == "moe" and moe_dispatch == "sparse":
        raise ValueError("data parallelism with moe_dispatch='sparse' "
                         "changes the capacity semantics (slots are "
                         "allocated per rank's slab, not per batch): use "
                         "the dense dispatch")
    if fsdp_mesh is not None and dp is not None and dp is not fsdp_mesh:
        raise ValueError("FSDP reduces each unit's gradient over fsdp_mesh: "
                         "pass the same group as dp_group")
    moe = head_type == "moe"
    hk = dict(moe_dispatch=moe_dispatch, moe_capacity=moe_capacity)

    def logp_of(vit, head, images, bn_collect=None, feat_sink=None):
        n_tokens = images.shape[0] * (images.shape[1] // cfg.patch_size) ** 2
        remat = (not freeze_backbone) and n_tokens > REMAT_TOKENS
        return seg_forward(vit, head, cfg, head_type, images,
                           compute_dtype=compute_dtype, remat=remat,
                           freeze_backbone=freeze_backbone,
                           backbone=backbone, bn_collect=bn_collect,
                           feat_sink=feat_sink, bn_group=dp,
                           tp_group=tp_group, **hk)

    def forward(vit, head, images, fs, bn_collect=None, extra=None):
        """(log-probs, ``extra(head, feats)`` or None) of a batch; under
        FSDP (``fs``) one unit gathered at a time."""
        if fs is not None:
            out = seg_forward_units(fs, vit, head, cfg, head_type, [images],
                                    compute_dtype, extra, **hk)[0]
            return out[0], out[1] if extra is not None else None
        sink = {} if extra is not None else None
        logp = logp_of(vit, head, images, bn_collect, sink)
        return logp, None if extra is None else extra(head, sink["feats"])

    def monolithic(vit, head, images, labels, mask, fs):
        bn_collect = {} if backbone != "vit" else None
        y = labels.reshape(-1)
        # per-sample mask -> per-patch weights: padded tail samples touch
        # neither the loss, the gradients nor the confusion matrix
        w = (None if mask is None else mask.float().repeat_interleave(
            y.shape[0] // mask.shape[0]))
        extra = ((lambda h, f: moe_balance_loss(h, f, weights=w)) if moe
                 else None)
        logp, balance = forward(vit, head, images, fs, bn_collect, extra)
        loss = nll_loss(logp, y, w)
        if moe:
            loss = loss + MOE_BALANCE_COEF * balance
        loss.backward()
        cm = confusion_matrix(logp.detach().argmax(dim=-1), y, n_classes, w)
        return loss.detach(), cm, bn_collect

    @torch.no_grad()
    def routing_fractions(vit, head, images, w, mb, w_total, fs):
        """The stats pass: the full batch's routing fractions f (E,) from a
        forward-only pass over the microbatches (and the ranks)."""
        a_tot, xs = 0, []
        for i in range(accum_steps):
            x = normalize_imagenet(images[i * mb:(i + 1) * mb])
            if compute_dtype is not None:
                x = x.to(compute_dtype)
            xs.append(x)
        if fs is None:
            for i, x in enumerate(xs):
                feats = backbone_features(vit, x, cfg, backbone,
                                          tp_group=tp_group)
                a_tot = a_tot + moe_balance_stats(head, feats,
                                                  weights=w[i])[0]
        else:  # every microbatch through one unit at a time
            feats = unit_features(fs, vit, xs, cfg)
            for (a,) in run_unit(fs.unit_of(head), lambda f, wi:
                                 moe_balance_stats(head, f, weights=wi)[0],
                                 [(f, w[i]) for i, f in enumerate(feats)]):
                a_tot = a_tot + a
        if dp is not None:
            all_reduce_sum_([a_tot], dp)
        return a_tot / w_total

    def accumulated(vit, head, params, images, labels, mask, fs):
        k = accum_steps
        b = images.shape[0]
        mb = b // k
        n_patch = (images.shape[1] // cfg.patch_size) ** 2
        m = (torch.ones(b, device=images.device) if mask is None
             else mask.float())
        w = m.repeat_interleave(n_patch).reshape(k, mb * n_patch)
        w_total = m.sum() * n_patch
        if dp is not None:
            all_reduce_sum_([w_total], dp)
        w_total = w_total.clamp_min(1.0)
        f_router = (routing_fractions(vit, head, images, w, mb, w_total, fs)
                    if moe else None)
        bn_collect = {} if backbone != "vit" else None
        loss_sum = torch.zeros((), device=images.device)
        cm = torch.zeros((n_classes, n_classes), dtype=torch.int64,
                         device=images.device)

        def b_sum_of(h, f, wi):
            return moe_balance_stats(h, f, weights=wi)[1]

        def microbatch_loss(i, logp, b_sum):
            """Microbatch i's summed masked loss; adds to the loss sum and
            the confusion matrix."""
            nonlocal loss_sum, cm
            y = labels[i * mb:(i + 1) * mb].reshape(-1)
            picked = logp.gather(1, y.long()[:, None])[:, 0]
            ls = -(picked * w[i]).sum()
            if moe:
                ls = ls + (MOE_BALANCE_COEF * f_router.shape[0]
                           * torch.dot(f_router, b_sum))
            loss_sum += ls.detach()
            cm += confusion_matrix(logp.detach().argmax(dim=-1), y,
                                   n_classes, w[i])
            return ls

        if fs is None:
            for i in range(k):
                logp, b_sum = forward(
                    vit, head, images[i * mb:(i + 1) * mb], None, bn_collect,
                    (lambda h, f, wi=w[i]: b_sum_of(h, f, wi)) if moe
                    else None)
                microbatch_loss(i, logp, b_sum).backward()
        else:  # every microbatch through one unit at a time, one backward
            outs = seg_forward_units(
                fs, vit, head, cfg, head_type,
                [images[i * mb:(i + 1) * mb] for i in range(k)],
                compute_dtype, b_sum_of if moe else None,
                [(w[i],) for i in range(k)] if moe else None, **hk)
            total = 0
            for i, out in enumerate(outs):
                total = total + microbatch_loss(i, out[0],
                                                out[1] if moe else None)
            total.backward()
        if fs is not None:  # each unit's backward reduced its gradient
            if dp is not None:
                all_reduce_sum_([loss_sum, cm], dp)
            fs.shard_grads()
            grads = fs.unit_grads()
        else:
            if dp is not None:
                for p in params:  # every rank sums the same list of tensors
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                all_reduce_sum_([loss_sum, cm] + [p.grad for p in params],
                                dp)
            grads = [p.grad for p in params if p.grad is not None]
        for g in grads:
            g.div_(w_total)
        return loss_sum / w_total, cm, bn_collect

    def step(vit, head, opt_state, images_u8, labels, mask=None):
        if accum_steps > 1 and images_u8.shape[0] % accum_steps:
            raise ValueError(
                f"batch {images_u8.shape[0]} must divide by "
                f"accum_steps={accum_steps} (microbatches are equal-sized)")
        for group, kind in ((zero_mesh, ShardedOptimizer),
                            (fsdp_mesh, FSDPOptimizer)):
            if group is not None and not (isinstance(opt_state, kind)
                                          and opt_state.group is group):
                raise TypeError("zero_mesh / fsdp_mesh need opt_state from "
                                "init_opt_state(..., zero_mesh= / "
                                "fsdp_mesh=) over the same group")
        if tp_group is not None and not (
                isinstance(vit, TPVisionTransformer)
                and vit.rank == get_rank(tp_group)
                and vit.world == get_world_size(tp_group)):
            raise TypeError("make_train_step(tp_group=...) trains this "
                            "rank's shard of the backbone: pass "
                            "parallel.tp.tp_shard_vit(vit, tp_group)")
        fs = opt_state if isinstance(opt_state, FSDPOptimizer) else None
        if fs is not None:  # a rank's slab, or every rank the whole batch
            fs.book.sum_ranks = dp is not None
        params = optimizer_params(opt_state)
        with matmul_ctx(compute_dtype):
            opt_state.zero_grad(set_to_none=True)
            if accum_steps > 1 or dp is not None:
                loss, cm, bn_collect = accumulated(vit, head, params,
                                                   images_u8, labels, mask,
                                                   fs)
            else:
                loss, cm, bn_collect = monolithic(vit, head, images_u8,
                                                  labels, mask, fs)
            opt_state.step()
        if bn_collect:
            update_bn_stats(bn_collect)
        return loss, cm

    return step


def make_eval_step(cfg: ViTConfig, head_type: str, n_classes: int,
                   compute_dtype: Optional[torch.dtype] = None,
                   backbone: str = "vit", moe_dispatch: str = "dense",
                   moe_capacity: float = 1.25, fsdp=None) -> Callable:
    """``step(vit, head, images_u8, labels) -> cm``, no gradient (BatchNorm
    in eval mode).  ``fsdp`` (an ``FSDPOptimizer`` over the model's units)
    gathers one unit at a time."""
    @torch.no_grad()
    def step(vit, head, images, labels):
        with matmul_ctx(compute_dtype):
            if fsdp is not None:
                logp = seg_forward_units(fsdp, vit, head, cfg, head_type,
                                         [images], compute_dtype,
                                         moe_dispatch=moe_dispatch,
                                         moe_capacity=moe_capacity)[0][0]
            else:
                logp = seg_forward(vit, head, cfg, head_type, images,
                                   compute_dtype=compute_dtype,
                                   backbone=backbone,
                                   moe_dispatch=moe_dispatch,
                                   moe_capacity=moe_capacity)
        return confusion_matrix(logp.argmax(dim=-1), labels.reshape(-1),
                                n_classes)
    return step


def make_feature_fn(cfg: ViTConfig,
                    compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """``fn(vit, images_u8) -> (B, N_patches, D)`` backbone features, the
    tensor seg_forward feeds the head, with no gradient (the frozen-backbone
    feature cache).  ViT only: a BatchNorm backbone updates its running
    stats even when frozen, so its features change from epoch to epoch."""
    @torch.no_grad()
    def fn(vit, images_u8):
        x = normalize_imagenet(images_u8)
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        with matmul_ctx(compute_dtype):
            return vit_forward(vit, x, cfg)[:, 1:, :]
    return fn


def make_cached_head_train_step(head_type: str, n_classes: int,
                                optimizer: Optimizer,
                                moe_dispatch: str = "dense",
                                moe_capacity: float = 1.25) -> Callable:
    """Head-only train step over a device-resident feature cache.

    ``step(head, opt_state, feats_all, labels_all, ids, mask=None) -> (loss,
    cm)`` gathers the batch's rows ``ids`` of ``feats_all`` ((M, N, D), the
    whole dataset's backbone features from :func:`make_feature_fn`) and
    ``labels_all`` ((M, N)) on the device, so an epoch moves no pixels.
    Loss, gradient and confusion matrix are the frozen train step's, ragged
    tail mask included (the MoE balance term too), and ``opt_state`` is
    ``init_opt_state(..., freeze_backbone=True)``'s, so resume files serve
    both paths.  Float32 features run with TF32 off."""

    def step(head, opt_state, feats_all, labels_all, ids, mask=None):
        feats = feats_all.index_select(0, ids)
        y = labels_all.index_select(0, ids).reshape(-1)
        cdt = None if feats.dtype == torch.float32 else feats.dtype
        with matmul_ctx(cdt):
            opt_state.zero_grad(set_to_none=True)
            flat = feats.reshape(-1, feats.shape[-1])
            logp = head_apply(head_type, head, flat, moe_dispatch,
                              moe_capacity)
            w = (None if mask is None else mask.to(logp.dtype)
                 .repeat_interleave(y.shape[0] // mask.shape[0]))
            loss = nll_loss(logp, y, w)
            if head_type == "moe":
                loss = loss + MOE_BALANCE_COEF * moe_balance_loss(
                    head, flat, weights=w)
            loss.backward()
            opt_state.step()
        return loss.detach(), confusion_matrix(logp.detach().argmax(dim=-1),
                                               y, n_classes, w)
    return step


def make_cached_head_eval_step(head_type: str, n_classes: int,
                               moe_dispatch: str = "dense",
                               moe_capacity: float = 1.25) -> Callable:
    """``step(head, feats_all, labels_all) -> cm`` over the whole cached
    feature set in one call, no gradient."""
    @torch.no_grad()
    def step(head, feats_all, labels_all):
        cdt = None if feats_all.dtype == torch.float32 else feats_all.dtype
        with matmul_ctx(cdt):
            logp = head_apply(head_type, head,
                              feats_all.reshape(-1, feats_all.shape[-1]),
                              moe_dispatch, moe_capacity)
        return confusion_matrix(logp.argmax(dim=-1), labels_all.reshape(-1),
                                n_classes)
    return step
