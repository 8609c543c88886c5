"""Sequence-parallel ViT with ring attention over a process group.

The counterpart of ``dino_tpu/parallel/ring_attention.py``.  Tokens shard
over the ranks of a ``torch.distributed`` group; every block's attention
runs as a ring: each rank keeps its Q shard and passes its K/V shard to
rank+1 (:func:`~dino_tpu_torch.parallel.dist.ring_shift`, where the JAX
package ``ppermute``s), one dynamic-bound flash kernel per hop
(:func:`~dino_tpu_torch.ops.attention.flash_attention_with_lse_dyn`), with
the hop's normalized partial merged online by its log-sum-exp.  The global
padding lives in whichever shard is in hand, so each hop's valid-key bound,
clip(n_real - src * n_local, 0, n_local), is a host int.

Training runs through the ring: :class:`RingAttention` is the
``torch.autograd.Function`` of the JAX ``custom_vjp``; its backward is a
second ring with the global lse and D = rowsum(dO * O), one
:func:`~dino_tpu_torch.ops.attention.flash_attention_bwd_dyn` per hop, dQ
summed locally and the dK/dV accumulators travelling with their K/V shard.
Every rank runs the same collectives in the same order, in the forward and
in autograd's backward.  ``make_sp_train_step`` builds the unfrozen
finetune step on top, with the mlp, linear or (dense) MoE head; the MoE
balance term sums its 2E+1 statistics over the group, not the features;
``zero=True`` shards the optimizer's moments over the same group.

SP x TP (``vit_forward_sp_tp``, ``make_sp_tp_train_step``) composes the
ring over a data group with the Megatron block of ``parallel/tp.py`` over a
model group (``parallel/mesh.py:make_grid``): each rank rings its token
shard of its head group's q/k/v.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from dino_tpu_torch.models.heads import affine, head_apply, moe_balance_stats
from dino_tpu_torch.models.vit import (Block, ViTConfig, VisionTransformer,
                                       layer_norm, prepare_tokens)
from dino_tpu_torch.ops.attention import (flash_attention_bwd_dyn,
                                          flash_attention_with_lse_dyn)
from dino_tpu_torch.ops.preprocess import normalize_imagenet
from dino_tpu_torch.parallel.dist import (GroupSum, all_gather_seq,
                                          all_reduce_sum_, get_rank,
                                          get_world_size, ring_shift)
from dino_tpu_torch.parallel.mesh import ShardedOptimizer, optimizer_params
from dino_tpu_torch.parallel.tp import (make_composed_train_step,
                                        tp_block_apply, tp_pack_block,
                                        tp_rank_slice)
from dino_tpu_torch.precision import matmul_ctx
from dino_tpu_torch.train.loop import MOE_BALANCE_COEF
from dino_tpu_torch.train.metrics import confusion_matrix

_NEG_INF = -1e30


def _hop_valid(n_real: int, src: int, n_local: int) -> int:
    """Valid keys of shard ``src``: the global padding is masked."""
    return min(max(n_real - src * n_local, 0), n_local)


def _ring_fwd(q, k, v, scale: float, n_real: int, group):
    """Ring attention forward over shard-local (B, nh, N_local, hd) q/k/v
    -> (out (B, nh, N_local, hd), lse (B, nh, N_local, 1) float32).

    Each hop's output is a normalized partial in the input dtype; the f32
    merge rescales it by exp(lse_hop - m) as ``_ring_fwd_flash`` does.
    K/V rotate d-1 times (the JAX scan's last rotation is unused).
    """
    d, me = get_world_size(group), get_rank(group)
    b, nh, n_local, hd = q.shape
    m = torch.full((b, nh, n_local, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, nh, n_local, hd), dtype=torch.float32,
                      device=q.device)
    k_cur, v_cur = k, v
    for step in range(d):
        valid = _hop_valid(n_real, (me - step) % d, n_local)
        o_h, lse_h = flash_attention_with_lse_dyn(q, k_cur, v_cur, scale,
                                                  valid)
        lse_h = lse_h.reshape(b, nh, n_local, 1)
        m_new = torch.maximum(m, lse_h)
        r_old = torch.exp(m - m_new)
        r_new = torch.exp(lse_h - m_new)
        acc = acc * r_old + o_h.float() * r_new
        l = l * r_old + r_new
        m = m_new
        if step < d - 1:
            k_cur, v_cur = ring_shift([k_cur, v_cur], group)
    l = l.clamp_min(1e-30)
    return (acc / l).to(q.dtype), m + torch.log(l)


def _ring_bwd(q, k, v, out, lse, g, scale: float, n_real: int, group):
    """Reverse ring: float32 (dq, dk, dv) of the shard-local q/k/v.

    With the global lse and D, P's columns partition exactly across shards,
    so each hop's contribution is independent: dq sums locally, dk/dv
    accumulate into buffers that rotate with their K/V shard and are home
    after d rotations (K/V itself needs d-1).
    """
    d, me = get_world_size(group), get_rank(group)
    b, nh, n_local, _ = q.shape
    g = g.to(q.dtype).contiguous()
    dsum = (g.float() * out.float()).sum(dim=-1).reshape(b * nh, n_local)
    lse = lse.reshape(b * nh, n_local)
    k_cur, v_cur = k, v
    dq = dk_cur = dv_cur = None
    for step in range(d):
        valid = _hop_valid(n_real, (me - step) % d, n_local)
        dq_h, dk_h, dv_h = flash_attention_bwd_dyn(q, g, lse, dsum, k_cur,
                                                   v_cur, scale, valid)
        if step == 0:
            dq, dk_cur, dv_cur = dq_h, dk_h, dv_h
        else:
            dq, dk_cur, dv_cur = dq + dq_h, dk_cur + dk_h, dv_cur + dv_h
        if step < d - 1:
            k_cur, v_cur, dk_cur, dv_cur = ring_shift(
                [k_cur, v_cur, dk_cur, dv_cur], group)
        else:
            dk_cur, dv_cur = ring_shift([dk_cur, dv_cur], group)
    return dq, dk_cur, dv_cur


class RingAttention(torch.autograd.Function):
    """Ring attention whose backward is the reverse ring (the counterpart of
    the JAX package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, n_real, group):
        out, lse = _ring_fwd(q, k, v, scale, n_real, group)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.n_real, ctx.group = scale, n_real, group
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, out, lse, g, ctx.scale, ctx.n_real,
                               ctx.group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, n_real: int, group=None) -> torch.Tensor:
    """Ring attention over shard-local (B, nh, N_local, hd) q/k/v, the token
    shards laid out contiguously in rank order; global key positions >=
    ``n_real`` are masked.  Differentiable through :class:`RingAttention`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return RingAttention.apply(q, k, v, scale, n_real, group)
    return _ring_fwd(q, k, v, scale, n_real, group)[0]


# ---------------------------------------------------------------------------
# Sequence-parallel ViT blocks / forward
# ---------------------------------------------------------------------------

def _block_seq_parallel(blk: Block, tokens: torch.Tensor, cfg: ViTConfig,
                        n_real: int, group) -> torch.Tensor:
    """One transformer block on a token shard; only attention communicates.
    The JAX package's SP block: ``dense`` qkv/proj/fc1/fc2 (each rounded to
    the input dtype), exact-erf GELU, no fused MLP."""
    h = layer_norm(blk.norm1, tokens, cfg.ln_eps)
    b, n_local, c = h.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    qkv = affine(blk.attn.qkv, h, h.dtype).reshape(b, n_local, 3, nh, hd)
    qkv = qkv.permute(2, 0, 3, 1, 4).contiguous()
    out = ring_attention(qkv[0], qkv[1], qkv[2], cfg.scale, n_real, group)
    out = out.permute(0, 2, 1, 3).reshape(b, n_local, c)
    tokens = tokens + affine(blk.attn.proj, out, out.dtype)
    h = layer_norm(blk.norm2, tokens, cfg.ln_eps)
    h = F.gelu(affine(blk.mlp.fc1, h, h.dtype), approximate="none")
    return tokens + affine(blk.mlp.fc2, h, h.dtype)


def _local_tokens(vit: VisionTransformer, x: torch.Tensor, cfg: ViTConfig,
                  group):
    """prepare_tokens on every rank (replicated), padded to a multiple of
    the world size -> (this rank's (B, N_local, D) slice, n_real, n_pad)."""
    d, me = get_world_size(group), get_rank(group)
    tokens = prepare_tokens(vit, x, cfg)
    n_real = tokens.shape[1]
    n_pad = -(-n_real // d) * d
    n_local = n_pad // d
    tokens = F.pad(tokens, (0, 0, 0, n_pad - n_real))
    return tokens[:, me * n_local:(me + 1) * n_local], n_real, n_pad


def vit_forward_seq_parallel(vit: VisionTransformer, x: torch.Tensor,
                             cfg: ViTConfig, group=None) -> torch.Tensor:
    """Full ViT forward with the token axis sharded over ``group``.

    x: (B, H, W, 3) normalized image, the same on every rank.  Returns the
    normed tokens (B, N+1, D), gathered on every rank; matches
    ``vit_forward`` up to reduction order.
    """
    tok, n_real, _ = _local_tokens(vit, x, cfg, group)
    for blk in vit.blocks:
        tok = _block_seq_parallel(blk, tok, cfg, n_real, group)
    tok = layer_norm(vit.norm, tok, cfg.ln_eps)
    return all_gather_seq(tok, group, dim=1)[:, :n_real]


# ---------------------------------------------------------------------------
# SP x TP: ring attention over a data group, Megatron-split blocks over a
# model group
# ---------------------------------------------------------------------------

def _sp_tp_tokens(vit: VisionTransformer, x: torch.Tensor, cfg: ViTConfig,
                  data_group, model_group):
    """This rank's token shard after every SP x TP block and the final LN:
    (tokens (B, N_local, D), n_real, n_pad).  Each block is
    ``tp_block_apply`` on the rank's head group, its attention the ring
    over ``data_group``.  Raises where ``dino_tpu`` does: the model group's
    size must divide the heads and the hidden width."""
    t = get_world_size(model_group)
    if cfg.num_heads % t or cfg.mlp_hidden % t:
        raise ValueError(f"tensor-parallel degree {t} must divide both "
                         f"num_heads ({cfg.num_heads}) and mlp_hidden "
                         f"({cfg.mlp_hidden})")
    tok, n_real, n_pad = _local_tokens(vit, x, cfg, data_group)
    me = get_rank(model_group)

    def attn(q, k, v):
        return ring_attention(q, k, v, cfg.scale, n_real, data_group)
    for blk in vit.blocks:
        p = tp_rank_slice(tp_pack_block(blk, cfg), cfg, me, t)
        tok = tp_block_apply(p, tok, cfg, model_group, attn)
    return layer_norm(vit.norm, tok, cfg.ln_eps), n_real, n_pad


def vit_forward_sp_tp(vit: VisionTransformer, x: torch.Tensor,
                      cfg: ViTConfig, data_group=None,
                      model_group=None) -> torch.Tensor:
    """ViT forward with the tokens sharded over ``data_group`` and the block
    weights Megatron-split over ``model_group`` (``parallel/mesh.py:
    make_grid``): the counterpart of ``dino_tpu``'s ``vit_forward_sp_tp``
    on a (data, model) mesh.  ``vit`` is the standard module, the same on
    every rank; x (B, H, W, 3) normalized, the same on every rank.  Returns
    the normed tokens (B, N+1, D), gathered on every rank; matches
    ``vit_forward`` up to reduction order."""
    tok, n_real, _ = _sp_tp_tokens(vit, x, cfg, data_group, model_group)
    return all_gather_seq(tok, data_group, dim=1)[:, :n_real]


def make_sp_tp_train_step(cfg: ViTConfig, head_type: str, n_classes: int,
                          optimizer, data_group=None, model_group=None,
                          compute_dtype: Optional[torch.dtype] = None
                          ) -> Callable:
    """The unfrozen finetune step through the SP x TP forward: ``dino_tpu``'s
    ``make_sp_tp_train_step`` contract, ``step(vit, head, opt_state,
    images_u8, labels, mask=None) -> (loss, cm)`` with the parameters in
    the standard layout (the head-aligned packing and the rank's slice are
    taken under autograd inside the step) and one update, the same on
    every rank, of a plain optimizer over them.

    Each rank's loss covers its token shard's patches over the global
    denominator (``make_sp_train_step``'s form).  The gradients of the
    split weights (qkv, proj and fc1's kernels and the column biases; a
    rank's cover its slice) are summed over ``model_group``; the norms,
    the row-parallel biases, the embeddings and the head, whole on every
    rank of a model group, are not.  Then one sum over ``data_group``
    adds the loss, the confusion matrix and every gradient.  The mlp and
    linear heads only, as in ``dino_tpu``."""
    def features(vit, x):
        tok, n_real, _ = _sp_tp_tokens(vit, x, cfg, data_group, model_group)
        b, n_local, dim = tok.shape
        pos = (get_rank(data_group) * n_local
               + torch.arange(n_local, device=x.device))
        live = (pos >= 1) & (pos < n_real)
        rows = (torch.arange(b, device=x.device)[:, None] * (n_real - 1)
                + pos[None, :] - 1)
        return (tok.reshape(-1, dim),
                torch.where(live[None, :], rows, -1).reshape(-1))

    return make_composed_train_step(
        features, "SPxTP", head_type, n_classes, optimizer,
        loss_group=data_group, model_group=model_group,
        compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# Sequence-parallel training (finetune through the ring)
# ---------------------------------------------------------------------------

def moe_balance_sp(head, feats: torch.Tensor, w: torch.Tensor, group
                   ) -> torch.Tensor:
    """The MoE balance term of the whole (token-sharded) batch from this
    rank's features: the 2E+1 statistics summed over the group (the
    weights zero CLS, the padding and masked samples), E * <a/W, b/W>."""
    a_l, b_l, w_l = moe_balance_stats(head, feats, weights=w)
    n_exp = a_l.shape[0]
    stats = GroupSum.apply(torch.cat([a_l, b_l, w_l[None]]), group)
    a_g, b_g = stats[:n_exp], stats[n_exp:2 * n_exp]
    w_g = stats[2 * n_exp].clamp_min(1.0)
    return n_exp * torch.dot(a_g / w_g, b_g / w_g)


def make_sp_train_step(cfg: ViTConfig, head_type: str, n_classes: int,
                       optimizer, group=None,
                       compute_dtype: Optional[torch.dtype] = None,
                       zero: bool = False, moe_dispatch: str = "dense",
                       moe_capacity: float = 1.25) -> Callable:
    """Unfrozen finetune step with the token axis sharded over ``group``.

    ``step(vit, head, opt_state, images_u8, labels, mask=None) -> (loss,
    cm)``: ``train.loop.make_train_step``'s contract (updates ``vit``,
    ``head`` and ``opt_state`` in place; masked ragged tails; on-device
    confusion matrix), called with the same batch and weights on every rank.
    Labels are token-aligned: CLS and the global padding are dead tokens.
    Each rank takes -sum(picked * w) / denom over its own token shard with
    the GLOBAL denominator, runs its backward (through the ring), and one
    sum over the group adds the loss, the confusion matrix and every
    gradient: the embedding work is replicated, and each rank's gradients
    cover only its own token terms, so the sum is the replicated step's
    gradient.  No rank ever holds the whole sequence's activations.

    The MoE head's balance term comes from its statistics summed over the
    group (:func:`moe_balance_sp`); each rank adds 0.01 * balance / d, as
    the group sum that follows multiplies it by d, and the statistics'
    all-reduce sums their cotangents in the backward, so the summed
    gradient is the replicated step's.  Sparse dispatch would claim
    capacity per token shard, not per batch, and raises.

    ``zero=True``: ZeRO-1 over the same group the tokens shard on.
    ``opt_state`` is then a ``parallel/mesh.py:ShardedOptimizer`` over it
    (``ShardedOptimizer(init_opt_state(...), group)``; a plain optimizer is
    accepted in a world of one): each rank updates its shard of the
    moments from the summed gradients and the parameters are all-gathered,
    the same bits as the replicated update.
    """
    if head_type not in ("mlp", "linear", "moe"):
        raise ValueError(f"unknown head for SP training: {head_type!r}")
    if head_type == "moe" and moe_dispatch == "sparse":
        raise ValueError("SP training with moe_dispatch='sparse' changes "
                         "the capacity semantics (slots allocate per token "
                         "shard, not per batch, so different patches drop): "
                         "use the dense dispatch")

    def step(vit, head, opt_state, images_u8, labels, mask=None):
        d, me = get_world_size(group), get_rank(group)
        if zero and d > 1 and not isinstance(opt_state, ShardedOptimizer):
            raise TypeError("make_sp_train_step(zero=True) needs opt_state "
                            "as a parallel.mesh.ShardedOptimizer over the "
                            "SP group")
        params = optimizer_params(opt_state)
        with matmul_ctx(compute_dtype):
            opt_state.zero_grad(set_to_none=True)
            x = normalize_imagenet(images_u8)
            if compute_dtype is not None:
                x = x.to(compute_dtype)
            b, hgt, wdt, _ = x.shape
            n_patches = (hgt // cfg.patch_size) * (wdt // cfg.patch_size)
            tok, n_real, n_pad = _local_tokens(vit, x, cfg, group)
            sl = slice(me * (n_pad // d), (me + 1) * (n_pad // d))
            # token-aligned labels: position 0 = CLS (dead), then the
            # patches, then the global padding (dead)
            y_tok = F.pad(labels.reshape(b, n_patches).long(),
                          (1, n_pad - n_real))
            pos = torch.arange(n_pad, device=x.device)
            w_tok = ((pos >= 1) & (pos < n_real)).float().expand(b, n_pad)
            if mask is not None:  # padded tail samples drop out entirely
                w_tok = w_tok * mask.float()[:, None]
                denom = (mask.float().sum() * n_patches).clamp_min(1.0)
            else:
                denom = torch.tensor(float(b * n_patches), device=x.device)
            y_sh, w_sh = y_tok[:, sl].reshape(-1), w_tok[:, sl].reshape(-1)
            for blk in vit.blocks:
                tok = _block_seq_parallel(blk, tok, cfg, n_real, group)
            tok = layer_norm(vit.norm, tok, cfg.ln_eps)
            feats = tok.reshape(-1, tok.shape[-1])
            logp = head_apply(head_type, head, feats, moe_dispatch,
                              moe_capacity)
            picked = logp.gather(1, y_sh[:, None])[:, 0]
            loss = -(picked * w_sh).sum() / denom
            if head_type == "moe":
                loss = loss + (MOE_BALANCE_COEF
                               * moe_balance_sp(head, feats, w_sh, group) / d)
            loss.backward()
            cm = confusion_matrix(logp.detach().argmax(dim=-1), y_sh,
                                  n_classes, w_sh)
            loss = loss.detach()
            for p in params:  # every rank sums the same list of tensors
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            all_reduce_sum_([loss, cm] + [p.grad for p in params], group)
            opt_state.step()
        return loss, cm

    return step
