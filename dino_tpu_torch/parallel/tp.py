"""Megatron tensor parallelism over a ``torch.distributed`` process group.

The counterpart of ``dino_tpu/parallel/tp.py``: one implementation of the
tensor-parallel transformer block, shared by TP predict
(``DINOSeg.predict(parallelism='tp')``), the SP x TP forward and step
(``parallel/ring_attention.py``) and the DP x TP train step
(``train/loop.py``, ``tp_group``) and the PP x TP stages
(``parallel/pipeline.py``).

  * :func:`tp_pack_block` re-lays a block head-aligned, in ``dino_tpu``'s
    packing: ``qkv_w`` (nh, C, 3, hd), ``qkv_b`` (nh, 3, hd), ``proj_w``
    (nh, hd, C), ``fc1_w`` (C, H), ``fc2_w`` (H, C).  Pure reshapes and
    transposes, so autograd carries gradients back to the standard layout.
  * :func:`tp_rank_slice` stands for ``tp_block_spec``: this rank's head
    group and hidden columns of a packed block, in nn.Linear's (out, in)
    layout.  The heads split into contiguous groups as even as possible
    (6 heads on 4 ranks: 2, 2, 1, 1; a rank may hold none), the hidden
    columns evenly.
  * :func:`tp_block_apply` runs one block with ``dino_tpu``'s numerics: qkv
    and fc1 are column-parallel behind Megatron's f
    (``parallel/dist.py:CopyToGroup``), each product in float32 with its
    float32 bias and rounded once; attention runs on the local heads
    through ``attention_fn``; proj and fc2 are row-parallel, each a float32
    partial summed over the group by Megatron's g (``SumFromGroup``), then
    the float32 bias, the cast and the residual.  The fused LN+MLP kernel
    is not called: the hidden split needs the float32 partial before the
    sum, and ``dino_tpu``'s block never calls it either.  A rank with no
    head launches no attention kernel and still joins every collective.
  * :class:`TPVisionTransformer` holds one rank's shard as parameters (the
    DP x TP step trains it, and ZeRO shards its slices over the data
    group); :func:`tp_gather_state` writes a shard's values or gradients
    back into the standard layout (a collective).
  * :func:`tp_slice_experts` and :func:`tp_head_apply`: the MoE head
    expert-parallel (each rank holds and runs its experts, the combine
    summed over the group), the MLP and linear heads replicated.
  * :func:`make_composed_train_step`: the train step of the composed modes
    over each rank's token features.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from dino_tpu_torch.models.heads import (MoEHead, _experts, _top1, affine_t,
                                         dense, head_apply,
                                         moe_combine_sparse,
                                         moe_dispatch_table, moe_gate)
from dino_tpu_torch.models.vit import (Block, ViTConfig, VisionTransformer,
                                       layer_norm, prepare_tokens)
from dino_tpu_torch.ops.attention import flash_attention
from dino_tpu_torch.ops.preprocess import normalize_imagenet
from dino_tpu_torch.parallel.dist import (all_reduce_sum_, copy_to_group,
                                          get_rank, get_world_size,
                                          sum_from_group)
from dino_tpu_torch.parallel.mesh import optimizer_params
from dino_tpu_torch.precision import matmul_ctx
from dino_tpu_torch.train.metrics import confusion_matrix

Params = Dict[str, Any]

# a rank slice's tensors (tp_rank_slice, TPBlock's parameters)
SLICE_KEYS = ("qkv_w", "qkv_b", "proj_w", "proj_b", "fc1_w", "fc1_b",
              "fc2_w", "fc2_b")
# the standard-layout parameters a block splits over the ranks (dino_tpu's
# _vit_block_spec: the column-parallel kernels and biases, the row-parallel
# kernels); every other parameter is whole on every rank
TP_SLICED = ("attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight",
             "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight")


def head_groups(n_heads: int, world: int) -> List[Tuple[int, int]]:
    """Each rank's [first, last) head: contiguous groups as even as
    possible, the larger ones first."""
    base, extra = divmod(n_heads, world)
    out, h = [], 0
    for r in range(world):
        n = base + (r < extra)
        out.append((h, h + n))
        h += n
    return out


def check_tp_world(cfg: ViTConfig, world: int) -> None:
    """Raise ValueError unless ``world`` divides the block's split widths:
    ``dino_tpu`` shards the qkv, proj, fc1 and fc2 kernels' 3C, C and H
    dimensions over its devices and refuses a count that does not divide
    one of them."""
    for name, n in (("3 x embed_dim", 3 * cfg.embed_dim),
                    ("embed_dim", cfg.embed_dim),
                    ("mlp_hidden", cfg.mlp_hidden)):
        if n % world:
            raise ValueError(f"tensor parallelism over {world} ranks needs "
                             f"{name} ({n}) divisible by {world}")


def tp_pack_block(blk: Block, cfg: ViTConfig) -> Params:
    """A block's parameters in ``dino_tpu``'s head-aligned packing
    (``tp_pack_block``), as views and copies of the module's tensors."""
    c, nh, hd = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    return {
        "norm1": blk.norm1, "norm2": blk.norm2,
        # (nh, C, 3, hd): head h's q/k/v projection; the (3C, C) weight's
        # rows are (3, nh, hd)
        "qkv_w": blk.attn.qkv.weight.reshape(3, nh, hd, c)
                 .permute(1, 3, 0, 2),
        "qkv_b": blk.attn.qkv.bias.reshape(3, nh, hd).permute(1, 0, 2),
        "proj_w": blk.attn.proj.weight.t().reshape(nh, hd, c),
        "proj_b": blk.attn.proj.bias,
        "fc1_w": blk.mlp.fc1.weight.t(),                  # (C, H) col-split
        "fc1_b": blk.mlp.fc1.bias,
        "fc2_w": blk.mlp.fc2.weight.t(),                  # (H, C) row-split
        "fc2_b": blk.mlp.fc2.bias,
    }


def tp_rank_slice(packed: Params, cfg: ViTConfig, rank: int,
                  world: int) -> Params:
    """Rank ``rank``'s share of a packed block, nn.Linear-shaped: ``qkv_w``
    (3·hd·nh_l, C) with rows (head, q/k/v, d), ``qkv_b`` alike, ``proj_w``
    (C, nh_l·hd), ``fc1_w`` (H/world, C), ``fc1_b``, ``fc2_w`` (C,
    H/world); the norms and the row-parallel biases whole; ``heads`` =
    nh_l."""
    c, hid = cfg.embed_dim, cfg.mlp_hidden
    if hid % world:
        raise ValueError(f"tensor parallelism over {world} ranks needs "
                         f"mlp_hidden ({hid}) divisible by {world}")
    h0, h1 = head_groups(cfg.num_heads, world)[rank]
    k = hid // world
    c0, c1 = rank * k, (rank + 1) * k
    return {
        "norm1": packed["norm1"], "norm2": packed["norm2"], "heads": h1 - h0,
        "qkv_w": packed["qkv_w"][h0:h1].permute(0, 2, 3, 1).reshape(-1, c),
        "qkv_b": packed["qkv_b"][h0:h1].reshape(-1),
        "proj_w": packed["proj_w"][h0:h1].reshape(-1, c).t(),
        "proj_b": packed["proj_b"],
        "fc1_w": packed["fc1_w"][:, c0:c1].t(),
        "fc1_b": packed["fc1_b"][c0:c1],
        "fc2_w": packed["fc2_w"][c0:c1].t(),
        "fc2_b": packed["fc2_b"],
    }


def tp_serving_slices(vit: VisionTransformer, cfg: ViTConfig, rank: int,
                      world: int) -> List[Params]:
    """Every block's rank slice as detached contiguous copies (the TP
    predict path's cached weights; the norms stay the module's)."""
    out = []
    with torch.no_grad():
        for blk in vit.blocks:
            p = tp_rank_slice(tp_pack_block(blk, cfg), cfg, rank, world)
            out.append({k: (v.detach().contiguous() if torch.is_tensor(v)
                            else v) for k, v in p.items()})
    return out


def qkv_local(p: Params, h: torch.Tensor) -> torch.Tensor:
    """The column-parallel qkv of this rank's heads, (B, N, nh_l·3·hd) in
    h's dtype: the single-device layer's form (``dense``) on its rows."""
    return dense(h, p["qkv_w"], p["qkv_b"])


def fc1_local(p: Params, h: torch.Tensor) -> torch.Tensor:
    """The column-parallel fc1 of this rank's hidden columns, rounded once
    to h's dtype: the single-device layer's form (``affine``)."""
    return affine_t(h, p["fc1_w"], p["fc1_b"], h.dtype)


def tp_block_apply(p: Params, tokens: torch.Tensor, cfg: ViTConfig, group,
                   attention_fn: Callable[[torch.Tensor, torch.Tensor,
                                           torch.Tensor], torch.Tensor]
                   ) -> torch.Tensor:
    """One pre-LN block with the heads and the hidden columns split over
    ``group`` (``p`` from :func:`tp_rank_slice` of this rank).

    ``attention_fn(q, k, v) -> out`` runs on this rank's head group, each
    (B, nh_l, N, hd) and contiguous (the flash kernels' TMA maps are
    encoded from strides): the whole-sequence flash kernel, or ring
    attention over a sequence group.  ``tokens`` is the same on every
    rank of ``group``, and so is the result.
    """
    dt = tokens.dtype
    b, n, c = tokens.shape
    nh, hd = p["heads"], cfg.head_dim
    h = copy_to_group(layer_norm(p["norm1"], tokens, cfg.ln_eps), group)
    if nh:
        qkv = qkv_local(p, h).reshape(b, n, nh, 3, hd)
        qkv = qkv.permute(3, 0, 2, 1, 4).contiguous()
        out = attention_fn(qkv[0], qkv[1], qkv[2])
        out = out.permute(0, 2, 1, 3).reshape(b, n, nh * hd)
        part = affine_t(out, p["proj_w"], None)          # float32 partial
    elif torch.is_grad_enabled() and h.requires_grad:
        # no head here: a product over the empty head axis keeps this
        # rank's f in the backward, so its all-reduce meets the others'
        part = F.linear(F.linear(h.float(), p["qkv_w"].float()),
                        p["proj_w"].float())
    else:
        part = torch.zeros((b, n, c), dtype=torch.float32,
                           device=tokens.device)
    attn = sum_from_group(part, group) + p["proj_b"].float()
    tokens = tokens + attn.to(dt)
    h = copy_to_group(layer_norm(p["norm2"], tokens, cfg.ln_eps), group)
    h = F.gelu(fc1_local(p, h), approximate="none")
    part = affine_t(h, p["fc2_w"], None)
    mlp = sum_from_group(part, group) + p["fc2_b"].float()
    return tokens + mlp.to(dt)


def vit_forward_tp(vit: nn.Module, x: torch.Tensor, cfg: ViTConfig, group,
                   blocks: Optional[List[Params]] = None,
                   remat: bool = False) -> torch.Tensor:
    """The ViT forward with every block tensor-parallel over ``group`` and
    the flash kernels on the local heads: (B, H, W, 3) normalized -> (B,
    N+1, D) normed tokens, the same on every rank.  ``vit`` is a
    :class:`TPVisionTransformer` (its own blocks' slices), or a standard
    one with ``blocks`` (the rank's slices, :func:`tp_serving_slices`).
    ``remat`` recomputes each block in the backward pass (its collectives
    too, on every rank alike)."""
    if blocks is None:
        blocks = [blk.local() for blk in vit.blocks]

    def attn(q, k, v):
        return flash_attention(q, k, v, cfg.scale)
    tokens = prepare_tokens(vit, x, cfg)
    for p in blocks:
        if remat:
            tokens = torch.utils.checkpoint.checkpoint(
                tp_block_apply, p, tokens, cfg, group, attn,
                use_reentrant=False)
        else:
            tokens = tp_block_apply(p, tokens, cfg, group, attn)
    return layer_norm(vit.norm, tokens, cfg.ln_eps)


# ---------------------------------------------------------------------------
# One rank's shard as parameters (the DP x TP train step)
# ---------------------------------------------------------------------------

class TPBlock(nn.Module):
    """One block's rank slice as parameters (:func:`tp_rank_slice`'s
    layout) and its own LayerNorms."""

    def __init__(self, local: Params):
        super().__init__()
        self.norm1 = copy.deepcopy(local["norm1"])
        self.norm2 = copy.deepcopy(local["norm2"])
        self.heads = local["heads"]
        for k in SLICE_KEYS:
            t = local[k]
            setattr(self, k, nn.Parameter(t.detach().contiguous().clone(),
                                          requires_grad=t.requires_grad))

    def local(self) -> Params:
        return dict({k: getattr(self, k) for k in SLICE_KEYS},
                    norm1=self.norm1, norm2=self.norm2, heads=self.heads)


class TPVisionTransformer(nn.Module):
    """Rank ``rank``'s Megatron shard of a VisionTransformer over a group of
    ``world`` ranks: the embeddings and the final norm whole, each block a
    :class:`TPBlock`.  Its forward is :func:`vit_forward_tp`."""

    def __init__(self, vit: VisionTransformer, rank: int, world: int):
        super().__init__()
        cfg = vit.cfg
        check_tp_world(cfg, world)
        self.cfg, self.rank, self.world = cfg, rank, world
        self.cls_token = copy.deepcopy(vit.cls_token)
        self.pos_embed = copy.deepcopy(vit.pos_embed)
        self.patch_embed = copy.deepcopy(vit.patch_embed)
        self.blocks = nn.ModuleList(
            TPBlock(tp_rank_slice(tp_pack_block(blk, cfg), cfg, rank, world))
            for blk in vit.blocks)
        self.norm = copy.deepcopy(vit.norm)


def tp_shard_vit(vit: VisionTransformer, group=None) -> TPVisionTransformer:
    """This rank's shard of ``vit`` over ``group`` (the counterpart of
    ``shard_params(vit_p, vit_param_spec(n), mesh)`` on the model axis)."""
    return TPVisionTransformer(vit, get_rank(group), get_world_size(group))


def tp_gather_state(tvit: TPVisionTransformer, group=None,
                    grads: bool = False) -> Dict[str, torch.Tensor]:
    """The standard-layout state dict (VisionTransformer's names) of the
    shards held by ``group``'s ranks: their values, or with ``grads`` their
    gradients (zeros where there is none).  The slices are written into
    zero tensors and summed over the group (one all-reduce); the rest is
    this rank's own, whole on every rank.  A collective."""
    cfg, rank, world = tvit.cfg, tvit.rank, tvit.world
    c, nh, hd, hid = cfg.embed_dim, cfg.num_heads, cfg.head_dim, \
        cfg.mlp_hidden
    h0, h1 = head_groups(nh, world)[rank]
    k = hid // world
    c0, c1 = rank * k, (rank + 1) * k

    def val(t):
        if not grads:
            return t.detach()
        return t.grad if t.grad is not None else torch.zeros_like(t)

    out = {name: val(t) for name, t in tvit.named_parameters()
           if not name.startswith("blocks.")}
    sliced = []
    for i, blk in enumerate(tvit.blocks):
        pre = f"blocks.{i}."
        for name in ("norm1", "norm2"):
            ln = getattr(blk, name)
            out[pre + name + ".weight"] = val(ln.weight)
            out[pre + name + ".bias"] = val(ln.bias)
        out[pre + "attn.proj.bias"] = val(blk.proj_b)
        out[pre + "mlp.fc2.bias"] = val(blk.fc2_b)
        like = dict(dtype=blk.qkv_w.dtype, device=blk.qkv_w.device)
        qkv_w = torch.zeros(nh, 3, hd, c, **like)
        qkv_w[h0:h1] = val(blk.qkv_w).reshape(h1 - h0, 3, hd, c)
        qkv_b = torch.zeros(nh, 3, hd, **like)
        qkv_b[h0:h1] = val(blk.qkv_b).reshape(h1 - h0, 3, hd)
        proj_w = torch.zeros(c, nh, hd, **like)
        proj_w[:, h0:h1] = val(blk.proj_w).reshape(c, h1 - h0, hd)
        fc1_w = torch.zeros(hid, c, **like)
        fc1_w[c0:c1] = val(blk.fc1_w)
        fc1_b = torch.zeros(hid, **like)
        fc1_b[c0:c1] = val(blk.fc1_b)
        fc2_w = torch.zeros(c, hid, **like)
        fc2_w[:, c0:c1] = val(blk.fc2_w)
        full = [qkv_w, qkv_b, proj_w, fc1_w, fc1_b, fc2_w]
        sliced += full
        out[pre + "attn.qkv.weight"] = qkv_w
        out[pre + "attn.qkv.bias"] = qkv_b
        out[pre + "attn.proj.weight"] = proj_w
        out[pre + "mlp.fc1.weight"] = fc1_w
        out[pre + "mlp.fc1.bias"] = fc1_b
        out[pre + "mlp.fc2.weight"] = fc2_w
    all_reduce_sum_(sliced, group)
    for i in range(len(tvit.blocks)):
        pre = f"blocks.{i}."
        out[pre + "attn.qkv.weight"] = (out[pre + "attn.qkv.weight"]
                                        .permute(1, 0, 2, 3).reshape(3 * c, c))
        out[pre + "attn.qkv.bias"] = (out[pre + "attn.qkv.bias"]
                                      .permute(1, 0, 2).reshape(3 * c))
        out[pre + "attn.proj.weight"] = out[pre + "attn.proj.weight"].reshape(
            c, c)
    return out


def tp_sliced_params(vit: VisionTransformer) -> List[torch.Tensor]:
    """The standard-layout parameters that :func:`tp_rank_slice` splits
    (``TP_SLICED``): their gradients from a rank cover only its slice."""
    return [p for name, p in vit.named_parameters()
            if name.startswith("blocks.") and name.split(".", 2)[2]
            in TP_SLICED]


# ---------------------------------------------------------------------------
# The head: the MoE experts split over the ranks
# ---------------------------------------------------------------------------

def tp_slice_experts(head: MoEHead, rank: int, world: int
                     ) -> Tuple[MoEHead, int]:
    """(a MoE head of rank ``rank``'s experts, detached copies, with the
    whole router shared; the index of its first expert): ``dino_tpu``'s
    ``head_param_spec('moe')``, the stacked expert axis split over the
    ranks."""
    n_exp = head.router.out_features
    if n_exp % world:
        raise ValueError(f"parallelism='tp' with head='moe' needs n_experts "
                         f"divisible by the world size ({world}); got "
                         f"{n_exp}")
    k = n_exp // world
    e0 = rank * k
    local = MoEHead(head.layer_3.weight.shape[-1], head.router.in_features, k)
    local.router = head.router
    with torch.no_grad():
        for name in ("layer_1", "layer_2", "layer_3"):
            src, dst = getattr(head, name), getattr(local, name)
            dst.weight = nn.Parameter(src.weight[e0:e0 + k].detach().clone())
            dst.bias = nn.Parameter(src.bias[e0:e0 + k].detach().clone())
    return local.to(head.router.weight.device), e0


def tp_head_apply(head_type: str, head: nn.Module, feats: torch.Tensor,
                  group, expert0: int = 0, moe_dispatch: str = "dense",
                  moe_capacity: float = 1.25) -> torch.Tensor:
    """(M, D) -> (M, n_classes) log-probs on every rank of ``group``.  The
    MLP and linear heads run whole on every rank.  The MoE head ``head``
    holds this rank's experts from ``expert0`` (:func:`tp_slice_experts`):
    the router picks among all experts on every rank, each rank computes
    its experts' logits (every patch under the dense dispatch, its slots of
    the capacity table under the sparse one) into the rows they own, and
    one all-reduce adds them.  Each row has one nonzero term, so the sum
    gives the single-device head's bits."""
    if head_type != "moe":
        return head_apply(head_type, head, feats, moe_dispatch, moe_capacity)
    gate = moe_gate(head, feats)
    best, top_w = _top1(gate)
    n_local = head.layer_1.weight.shape[0]
    if moe_dispatch == "sparse":
        idx = moe_dispatch_table(best, gate.shape[-1], moe_capacity)
        out = moe_combine_sparse(head, feats, idx[expert0:expert0 + n_local])
    elif moe_dispatch == "dense":
        y = _experts(head, feats.expand(n_local, *feats.shape), feats.dtype)
        mine = (best >= expert0) & (best < expert0 + n_local)
        rows = torch.arange(feats.shape[0], device=feats.device)
        picked = y.permute(1, 0, 2)[rows, (best - expert0).clamp(
            0, n_local - 1)]
        out = torch.where(mine[:, None], picked, torch.zeros_like(picked))
    else:
        raise ValueError(f"unknown moe_dispatch {moe_dispatch!r}")
    all_reduce_sum_([out], group)
    return torch.log_softmax(out * top_w, dim=-1)


# ---------------------------------------------------------------------------
# The composed train step
# ---------------------------------------------------------------------------

def make_composed_train_step(features_fn: Callable, mode: str,
                             head_type: str, n_classes: int, optimizer,
                             loss_group=None, model_group=None,
                             compute_dtype: Optional[torch.dtype] = None
                             ) -> Callable:
    """The unfrozen train step of the composed parallel modes, built once:
    ``make_train_step``'s contract, ``step(vit, head, opt_state, images_u8,
    labels, mask=None) -> (loss, cm)`` with ``vit`` and ``head`` in the
    standard layout, updated in place by one optimizer step, the same on
    every rank.

    ``features_fn(vit, x) -> (feats (M_l, D), rows (M_l,))``: this rank's
    token features and each one's row among the batch's B·N_patches patch
    rows (-1 for a dead token: CLS, padding).  Each rank takes -sum(picked ·
    w) over its rows over the global weight total and runs its backward.
    Then the gradients of the tensor-parallel slices (:data:`TP_SLICED`,
    disjoint between ``model_group``'s ranks) are summed over it, and the
    loss, the confusion matrix and every gradient over ``loss_group`` (the
    ranks whose rows differ).  A gradient that every rank of
    ``model_group`` holds whole is not summed there.  ``loss_group`` may
    be a sequence of groups whose ranks' rows differ (DP x PP x TP's data
    and stage groups): the sums run over each in turn.
    """
    if head_type not in ("mlp", "linear"):
        raise ValueError(f"{mode} training supports the mlp/linear heads; "
                         f"got {head_type!r}")

    def step(vit, head, opt_state, images_u8, labels, mask=None):
        params = optimizer_params(opt_state)
        sliced = {id(p) for p in tp_sliced_params(vit)}
        with matmul_ctx(compute_dtype):
            opt_state.zero_grad(set_to_none=True)
            x = normalize_imagenet(images_u8)
            if compute_dtype is not None:
                x = x.to(compute_dtype)
            b = x.shape[0]
            y_all = labels.reshape(-1).long()
            n_patches = y_all.shape[0] // b
            w_all = (torch.ones(b * n_patches, device=x.device)
                     if mask is None else
                     mask.float().repeat_interleave(n_patches))
            denom = w_all.sum().clamp_min(1.0)
            feats, rows = features_fn(vit, x)
            live = rows >= 0
            y = y_all[rows.clamp_min(0)]
            w = w_all[rows.clamp_min(0)] * live
            logp = head_apply(head_type, head, feats)
            picked = logp.gather(1, y[:, None])[:, 0]
            loss = -(picked * w).sum() / denom
            loss.backward()
            cm = confusion_matrix(logp.detach().argmax(dim=-1), y,
                                  n_classes, w)
            loss = loss.detach()
            for p in params:  # every rank sums the same list of tensors
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            all_reduce_sum_([p.grad for p in params if id(p) in sliced],
                            model_group)
            groups = (loss_group if isinstance(loss_group, (tuple, list))
                      else (loss_group,))
            for group in groups:
                all_reduce_sum_([loss, cm] + [p.grad for p in params], group)
            opt_state.step()
        return loss, cm

    return step
