"""Pipeline parallelism over a ``torch.distributed`` process group: the ViT's
blocks in stages, one stage a rank.

The counterpart of ``dino_tpu/parallel/pipeline.py``.  Where the JAX package
stacks every stage's blocks on a leading axis sharded ``P('stage')`` inside
one ``shard_map``, each rank here holds its own stage and the stages talk
through :func:`~dino_tpu_torch.parallel.dist.stage_hop` (``ppermute``'s
counterpart: activations +1, cotangents -1, both rings wrapping).

Placement (:func:`pp_shard_vit`, for ``stack_block_stages`` /
``stack_block_chunks`` and their ``device_put``): contiguous, rank s holds
blocks [s*per, (s+1)*per); interleaved over V chunks, chunk c = v*S + s
holds blocks [c*per, (c+1)*per) and lives on rank s.  A :class:`StageViT`
holds the rank's blocks and, whole, the embeddings and the final norm (the
JAX steps' ``rest``); :func:`pp_gather_state` rebuilds the standard
depth-ordered backbone on every rank (``unstack_block_stages`` /
``unstack_block_chunks``).  ``train.loop.init_opt_state(optimizer, svit,
head, False)`` is ``init_pp_train_state``: a rank's optimizer holds the
moments of its own blocks, of the embeddings, the norm and the head.

Schedules, each one ``dino_tpu``'s:

  * the fill-drain (GPipe; interleaved with V chunks): T = M + S*V - 1
    ticks, chunk c = v*S + s takes microbatch m at tick m + c.  JAX
    differentiates it; here :class:`_FillDrain` runs the forward ticks
    keeping each one's graph (``remat``: ``torch.utils.checkpoint``), and
    its backward runs the reverse ticks, each a ``torch.autograd.backward``
    of the tick's output with the cotangent from rank s+1.  The final norm
    and head shard over the stages: the last stage's bank is summed to
    every rank (:class:`~dino_tpu_torch.parallel.dist.GroupSum`), each rank
    scores its 1/S chunk of the patch tokens, and the chunk cotangents sum
    back.  :func:`vit_forward_pipelined`, :func:`make_pp_train_step`,
    :func:`make_pp_interleaved_train_step`, and the PP x TP pair;
  * 1F1B (PipeDream-flush), contiguous and interleaved, hand-scheduled on
    ``dino_tpu``'s tick table (:func:`_one_f_one_b`; the contiguous table
    is the interleaved one at V = 1): forward f(m, c) at tick g*C + v*S + r
    + s (m = g*S + r, C = S*V), the head's backward on the last stage right
    after chunk C-1's forward, backward b(m, c) at tick C + g*C +
    (V-1-v)*S + r + (S-1-s).  The stage input goes to a ring of 2C slots
    and the backward slot re-runs its chunk from it under autograd (the
    recompute that bounds memory to O(S*V) microbatches whatever M is).

Every rank posts every hop of every tick the JAX program's static form
runs; a rank skips the compute of an off-window slot, never the hop (an
idle slot sends zeros nobody reads).  The fused LN+MLP kernel runs only in
the inference forward: a train step's forward slots run the composition
their backward recomputes (``block_apply(..., fused_mlp=False)``).

Gradients: block gradients stay on their rank; the embeddings' (stage 0),
the norm's and the head's (the last stage, or each rank's head chunk) are
summed over the stage group once, so every rank makes the same update of
those and its own of its blocks.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.utils.checkpoint

from dino_tpu_torch.models.heads import head_apply
from dino_tpu_torch.models.vit import (ViTConfig, VisionTransformer,
                                       block_apply, layer_norm,
                                       prepare_tokens)
from dino_tpu_torch.ops.attention import attention_with_probs, flash_attention
from dino_tpu_torch.ops.preprocess import normalize_imagenet
from dino_tpu_torch.parallel.dist import (GroupSum, all_gather_seq,
                                          all_reduce_sum_, get_rank,
                                          get_world_size, stage_hop)
from dino_tpu_torch.parallel.mesh import optimizer_params
from dino_tpu_torch.parallel.ring_attention import moe_balance_sp
from dino_tpu_torch.parallel.tp import (make_composed_train_step,
                                        tp_block_apply, tp_pack_block,
                                        tp_rank_slice)
from dino_tpu_torch.precision import matmul_ctx
from dino_tpu_torch.train.loop import MOE_BALANCE_COEF
from dino_tpu_torch.train.metrics import confusion_matrix


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def stage_block_ids(depth: int, n_stages: int, stage: int,
                    n_chunks: int = 1) -> List[int]:
    """The standard indices of the blocks rank ``stage`` holds, chunk by
    chunk: chunk v is blocks [(v*S + stage)*per, (v*S + stage + 1)*per).
    Raises ``dino_tpu``'s errors when the depth does not divide."""
    if n_chunks == 1 and depth % n_stages:
        raise ValueError(f"depth {depth} not divisible by {n_stages} stages")
    if depth % (n_stages * n_chunks):
        raise ValueError(f"depth {depth} not divisible by stages x chunks "
                         f"({n_stages} x {n_chunks})")
    per = depth // (n_stages * n_chunks)
    return [(v * n_stages + stage) * per + i
            for v in range(n_chunks) for i in range(per)]


class StageViT(nn.Module):
    """Rank ``stage``'s stage of a ViT over ``n_stages`` ranks: copies of the
    embeddings and the final norm, whole, and of its blocks only
    (``blocks[v*per + i]`` is block i of its chunk v, the standard block
    ``block_ids[v*per + i]``)."""

    def __init__(self, vit: VisionTransformer, stage: int, n_stages: int,
                 n_chunks: int = 1):
        super().__init__()
        self.cfg = vit.cfg
        self.stage, self.n_stages, self.n_chunks = stage, n_stages, n_chunks
        self.block_ids = stage_block_ids(len(vit.blocks), n_stages, stage,
                                         n_chunks)
        self.per = len(self.block_ids) // n_chunks
        self.cls_token = copy.deepcopy(vit.cls_token)
        self.pos_embed = copy.deepcopy(vit.pos_embed)
        self.patch_embed = copy.deepcopy(vit.patch_embed)
        self.blocks = nn.ModuleList(copy.deepcopy(vit.blocks[i])
                                    for i in self.block_ids)
        self.norm = copy.deepcopy(vit.norm)
        for p in self.parameters():
            p.grad = None

    def chunk(self, v: int) -> List[nn.Module]:
        return list(self.blocks)[v * self.per:(v + 1) * self.per]

    def standard_name(self, name: str) -> str:
        """A parameter's name in the standard VisionTransformer."""
        if not name.startswith("blocks."):
            return name
        _, i, rest = name.split(".", 2)
        return f"blocks.{self.block_ids[int(i)]}.{rest}"

    def rest_parameters(self) -> List[nn.Parameter]:
        """The parameters every stage holds whole (embeddings, norm)."""
        return [p for n, p in self.named_parameters()
                if not n.startswith("blocks.")]


def pp_shard_vit(vit: VisionTransformer, group=None,
                 n_chunks: int = 1) -> StageViT:
    """This rank's stage of ``vit`` over ``group`` (contiguous, or
    interleaved over ``n_chunks`` chunks): ``stack_block_stages`` /
    ``stack_block_chunks`` and the stage sharding, on ``vit``'s device."""
    return StageViT(vit, get_rank(group), get_world_size(group), n_chunks)


def _gather(contrib: Dict[str, Optional[torch.Tensor]],
            like: Dict[str, torch.Tensor], device,
            group) -> Dict[str, torch.Tensor]:
    """Each name's tensor from the rank that passes it (zeros elsewhere),
    on every rank: one all-reduce over ``group``."""
    out = {}
    for name, ref in like.items():
        t = contrib.get(name)
        out[name] = (t.detach().to(device).clone() if t is not None else
                     torch.zeros(ref.shape, dtype=ref.dtype, device=device))
    all_reduce_sum_(list(out.values()), group)
    return out


def pp_gather_state(svit: Optional[StageViT], vit: VisionTransformer,
                    group=None, grads: bool = False) -> Dict[str,
                                                             torch.Tensor]:
    """The standard-layout state dict (VisionTransformer's names) of the
    stages held by ``group``'s ranks, on every rank: each block's values,
    or with ``grads`` its gradient (zeros where there is none), from the
    rank that holds it; the embeddings and the final norm from the stage-0
    rank.  ``vit`` gives the names, shapes and dtypes only.  A rank of
    ``group`` without a stage passes ``svit=None`` and adds nothing.  A
    collective: one all-reduce (``unstack_block_stages`` /
    ``unstack_block_chunks`` after ``gather_if_sharded``)."""
    like = dict(vit.named_parameters())
    contrib, device = {}, vit.cls_token.device
    if svit is not None:
        device = svit.cls_token.device
        for name, p in svit.named_parameters():
            if name.startswith("blocks.") or svit.stage == 0:
                val = p.grad if grads else p
                contrib[svit.standard_name(name)] = (
                    val if val is not None else torch.zeros_like(p))
    return _gather(contrib, like, device, group)


def _plain_index(svit: StageViT, head: nn.Module,
                 vit: VisionTransformer) -> List[int]:
    """For each parameter of the PP optimizer (``init_opt_state``'s order:
    the head, then the stage), its index in the plain optimizer over the
    head and the standard backbone."""
    n_head = len(list(head.parameters()))
    std = {n: i for i, (n, _) in enumerate(vit.named_parameters())}
    return list(range(n_head)) + [n_head + std[svit.standard_name(n)]
                                  for n, _ in svit.named_parameters()]


def pp_optimizer_state(opt: torch.optim.Optimizer, svit: StageViT,
                       head: nn.Module, vit: VisionTransformer,
                       group=None) -> Dict[str, Dict[str, Any]]:
    """A PP optimizer's state in the plain optimizer's layout ({index:
    {name: tensor}} over the head and the standard backbone, as
    ``checkpointing/resume.py:optimizer_arrays`` writes it), on every rank
    of the stage group: a block's moments from its rank, the rest from
    stage 0.  So a resume file does not depend on the stage count.  A
    collective over ``group``; every parameter must have state."""
    head_params = list(head.parameters())
    names = [n for n, _ in svit.named_parameters()]
    params = head_params + list(svit.parameters())
    shapes = ([p.shape for p in head_params]
              + [p.shape for p in vit.parameters()])
    template = opt.state[params[0]]
    # a block's moments from its rank, the replicated parameters' from
    # stage 0 (every stage holds the same)
    owned = [svit.stage == 0] * len(head_params) + [
        svit.stage == 0 or n.startswith("blocks.") for n in names]
    mine = {i: opt.state[p] for i, p, own in
            zip(_plain_index(svit, head, vit), params, owned) if own}
    contrib, like, fixed = {}, {}, {}
    for i, shape in enumerate(shapes):
        for k, tv in template.items():
            if not torch.is_tensor(tv):
                fixed[(i, k)] = tv
                continue
            like[f"{i}/{k}"] = torch.empty(
                shape if tv.dim() else (), dtype=tv.dtype)
            if i in mine:
                contrib[f"{i}/{k}"] = mine[i][k]
    out = _gather(contrib, like, svit.cls_token.device, group)
    state: Dict[str, Dict[str, Any]] = {}
    for key, t in out.items():
        i, k = key.split("/")
        state.setdefault(i, {})[k] = t
    for (i, k), v in fixed.items():
        state.setdefault(str(i), {})[k] = np.asarray(v)
    return state


def pp_load_optimizer_state(opt: torch.optim.Optimizer, svit: StageViT,
                            head: nn.Module, vit: VisionTransformer,
                            arrays) -> None:
    """Inverse of :func:`pp_optimizer_state`: load a plain-layout state
    (host or device arrays) into this rank's PP optimizer, each parameter
    taking its own entry."""
    items = dict(arrays.items() if isinstance(arrays, dict)
                 else enumerate(arrays))
    items = {int(i): s for i, s in items.items()}
    sd = opt.state_dict()
    sd["state"] = {j: {k: torch.as_tensor(np.array(v) if not torch.is_tensor(v)
                                          else v)
                       for k, v in items[i].items()}
                   for j, i in enumerate(_plain_index(svit, head, vit))}
    opt.load_state_dict(sd)


# ---------------------------------------------------------------------------
# The fill-drain schedule (GPipe; interleaved with V chunks)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Plan:
    """One fill-drain sweep: ``run(v, h)`` is this rank's chunk v."""
    run: Callable[[int, torch.Tensor], torch.Tensor]
    group: Any
    n_chunks: int
    n_mb: int
    remat: bool = False

    @property
    def stages(self) -> int:
        return get_world_size(self.group)

    @property
    def stage(self) -> int:
        return get_rank(self.group)

    @property
    def ticks(self) -> int:
        return self.n_mb + self.stages * self.n_chunks - 1

    def slot(self, t: int):
        """(chunk v, microbatch m) this rank runs at tick t, or None: chunk
        c = v*S + s takes microbatch m at tick m + c (with V = 1 or M <= S
        at most one v fits)."""
        for v in range(self.n_chunks):
            m = t - v * self.stages - self.stage
            if 0 <= m < self.n_mb:
                return v, m
        return None

    def first(self, v: int) -> bool:
        return self.stage == 0 and v == 0

    def last(self, v: int) -> bool:
        return self.stage == self.stages - 1 and v == self.n_chunks - 1


def _fill_drain(tokens: torch.Tensor, plan: _Plan, ticks: Optional[dict]
                ) -> torch.Tensor:
    """The forward ticks: (B, 1+N, D) tokens (read on stage 0) -> the banked
    outputs, nonzero on the last stage.  With ``ticks`` (a dict) each
    active tick keeps its graph there: tick -> (input leaf, output)."""
    mbs = tokens.reshape((plan.n_mb, -1) + tokens.shape[1:])
    out = torch.zeros_like(mbs)
    idle = torch.zeros_like(mbs[0])
    recv = idle
    for t in range(plan.ticks):
        y = idle
        slot = plan.slot(t)
        if slot is not None:
            v, m = slot
            h = mbs[m] if plan.first(v) else recv
            if ticks is None:
                y = plan.run(v, h)
            else:
                with torch.enable_grad():
                    h = h.detach().requires_grad_()
                    y = (torch.utils.checkpoint.checkpoint(
                        plan.run, v, h, use_reentrant=False)
                        if plan.remat else plan.run(v, h))
                ticks[t] = (h, y)
            if plan.last(v):
                out[m] = y.detach()
        if t < plan.ticks - 1:
            recv, _ = stage_hop(y.detach(), None, plan.group)
    return out.reshape(tokens.shape)


class _FillDrain(torch.autograd.Function):
    """The fill-drain as one autograd node: its backward is the reverse
    drain-fill (``dino_tpu`` gets it by differentiating the forward).
    Each reverse tick backpropagates the tick's output with the cotangent
    from rank s+1 (the last chunk's from the banked outputs' cotangent) and
    hops the input's cotangent to rank s-1; the block gradients land in
    ``.grad``, the tokens' (stage 0) is returned.  Every rank calls it and
    its backward, so the hops meet."""

    @staticmethod
    def forward(ctx, tokens, plan):
        ctx.plan, ctx.ticks = plan, {}
        ctx.shape = tokens.shape
        return _fill_drain(tokens, plan, ctx.ticks)

    @staticmethod
    def backward(ctx, d_out):
        plan, ticks = ctx.plan, ctx.ticks
        d_out = d_out.reshape((plan.n_mb, -1) + d_out.shape[1:])
        d_tok = torch.zeros_like(d_out) if plan.stage == 0 else None
        idle = torch.zeros_like(d_out[0])
        recv = idle
        with torch.enable_grad():
            for t in reversed(range(plan.ticks)):
                send = idle
                slot = plan.slot(t)
                if slot is not None:
                    v, m = slot
                    h, y = ticks.pop(t)
                    g = d_out[m] if plan.last(v) else recv
                    torch.autograd.backward(y, g.to(y.dtype))
                    send = h.grad
                    if plan.first(v):
                        d_tok[m] = send
                if t > 0:
                    _, recv = stage_hop(None, send, plan.group)
        return (None if d_tok is None else d_tok.reshape(ctx.shape)), None


def _pipelined(tokens: torch.Tensor, plan: _Plan) -> torch.Tensor:
    """The banked fill-drain outputs summed over the stage group: (B, 1+N,
    D) on every rank, differentiable when autograd is on."""
    if torch.is_grad_enabled():
        if not tokens.requires_grad:  # the node must run on every rank
            tokens = tokens.detach().requires_grad_()
        return GroupSum.apply(_FillDrain.apply(tokens, plan), plan.group)
    out = _fill_drain(tokens, plan, None)
    all_reduce_sum_([out], plan.group)
    return out


def _chunk_rows(total: int, n_stages: int, stage: int):
    """[lo, hi): stage ``stage``'s rows of ``total`` in S equal chunks (the
    last one short where S does not divide; ``dino_tpu`` pads it with dead
    rows)."""
    chunk = -(-total // n_stages)
    return min(stage * chunk, total), min((stage + 1) * chunk, total)


def _chunk_head_loss(full: torch.Tensor, labels: torch.Tensor,
                     svit: StageViT, head: nn.Module, head_type: str,
                     cfg: ViTConfig, group, moe_dispatch: str = "dense",
                     moe_capacity: float = 1.25) -> torch.Tensor:
    """The norm and head sharded over the stages: this rank's partial of
    the mean NLL over the batch's B*N patch rows, from its 1/S chunk of
    them (the MoE head adds 0.01 * its balance term from the statistics
    summed over the group, over S, since the partials are summed)."""
    s, n_st = get_rank(group), get_world_size(group)
    feats = full[:, 1:, :].reshape(-1, full.shape[-1])
    total = feats.shape[0]
    lo, hi = _chunk_rows(total, n_st, s)
    normed = layer_norm(svit.norm, feats[lo:hi], cfg.ln_eps)
    logp = head_apply(head_type, head, normed, moe_dispatch, moe_capacity)
    y = labels.reshape(-1).long()[lo:hi].to(logp.device)
    partial = -logp.gather(1, y[:, None])[:, 0].float().sum() / total
    if head_type == "moe":
        w = torch.ones(hi - lo, device=normed.device)
        partial = partial + (MOE_BALANCE_COEF
                             * moe_balance_sp(head, normed, w, group) / n_st)
    return partial


def _stage_fn(svit: StageViT, cfg: ViTConfig, use_flash: bool,
              fused_mlp: bool) -> Callable[[int, torch.Tensor],
                                           torch.Tensor]:
    """run(v, h): the rank's chunk v.  ``use_flash=False`` takes the plain
    attention (materialized probabilities) and no fused MLP, as
    ``dino_tpu``'s ``block_apply(use_flash=False)``."""
    def run(v, h):
        for blk in svit.chunk(v):
            h = block_apply(blk, h, cfg, need_probs=not use_flash,
                            fused_mlp=fused_mlp and use_flash)[0]
        return h
    return run


def _check_stage(svit, group, n_chunks: int) -> None:
    if not (isinstance(svit, StageViT) and svit.n_chunks == n_chunks
            and svit.stage == get_rank(group)
            and svit.n_stages == get_world_size(group)):
        raise TypeError(f"the pipeline steps train this rank's stage: pass "
                        f"parallel.pipeline.pp_shard_vit(vit, group, "
                        f"n_chunks={n_chunks})")


def _sum_shared_grads(svit: StageViT, head: nn.Module, extra: Sequence,
                      group) -> None:
    """Sum ``extra`` and the gradients of the parameters every stage holds
    (embeddings, norm, head) over the stage group; a block's stays."""
    shared = svit.rest_parameters() + list(head.parameters())
    for p in shared:  # every rank sums the same list of tensors
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_sum_(list(extra) + [p.grad for p in shared], group)


# ---------------------------------------------------------------------------
# Forward and the fill-drain train steps
# ---------------------------------------------------------------------------

def vit_forward_pipelined(svit: StageViT, x: torch.Tensor, cfg: ViTConfig,
                          group=None, n_microbatches: int = 2,
                          use_flash: bool = True) -> torch.Tensor:
    """The ViT forward with the blocks pipelined over ``group`` (GPipe
    fill-drain, M + S - 1 ticks); ``svit`` is this rank's contiguous stage
    (:func:`pp_shard_vit`).  x (B, H, W, 3) normalized, the same on every
    rank, B divisible by M.  Returns the normed (B, 1+N, D) tokens on
    every rank, ``vit_forward``'s up to reduction order.  No gradient: the
    bf16 path on the card runs the fused MLP, as the single-card forward."""
    _check_stage(svit, group, 1)
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by {n_microbatches} "
                         f"microbatches")
    plan = _Plan(_stage_fn(svit, cfg, use_flash, True), group, 1,
                 n_microbatches)
    with torch.no_grad():
        out = _pipelined(prepare_tokens(svit, x, cfg), plan)
        return layer_norm(svit.norm, out, cfg.ln_eps)


def _fill_drain_loss(svit, head, cfg, head_type, x, labels, plan, hk):
    """One sweep's partial loss (the caller runs its backward)."""
    full = _pipelined(prepare_tokens(svit, x, cfg), plan)
    return _chunk_head_loss(full, labels, svit, head, head_type, cfg,
                            plan.group, **hk)


def make_pp_train_step(cfg: ViTConfig, head_type: str, n_classes: int,
                       optimizer, group=None, n_microbatches: int = 2,
                       use_flash: bool = True, remat: bool = False,
                       donate: bool = False, moe_dispatch: str = "dense",
                       moe_capacity: float = 1.25) -> Callable:
    """Unfrozen train step with the blocks pipelined over ``group`` on the
    GPipe fill-drain: ``step(svit, head, opt_state, images_u8, labels) ->
    loss``, ``svit`` this rank's contiguous stage (:func:`pp_shard_vit`),
    ``opt_state`` ``init_opt_state(optimizer, svit, head, False)``; every
    rank passes the same batch and updates its blocks, and every rank the
    embeddings, norm and head alike, in place.

    The forward ticks keep their graphs (``remat=True`` recomputes each
    tick in the backward); the reverse ticks run the backward stage by
    stage; the norm and head shard over the stages (see the module's
    docstring), the only PP step that takes the MoE head, whose balance
    term comes from its statistics summed over the stages.  True float32
    (TF32 off).  ``donate`` is accepted for ``dino_tpu``'s signature: the
    step updates in place either way."""
    if head_type not in ("mlp", "linear", "moe"):
        raise ValueError(f"unknown head for PP training: {head_type!r}")
    if head_type == "moe" and moe_dispatch == "sparse":
        raise ValueError("PP training with moe_dispatch='sparse' changes "
                         "the capacity semantics (slots allocate per stage "
                         "chunk, not per batch, so different patches drop) "
                         "— use the dense dispatch")
    hk = dict(moe_dispatch=moe_dispatch, moe_capacity=moe_capacity)

    def step(svit, head, opt_state, images_u8, labels):
        _check_stage(svit, group, 1)
        b = images_u8.shape[0]
        if b % n_microbatches:
            raise ValueError(f"batch {b} not divisible by {n_microbatches} "
                             f"microbatches")
        plan = _Plan(_stage_fn(svit, cfg, use_flash, False), group, 1,
                     n_microbatches, remat)
        with matmul_ctx(None):
            opt_state.zero_grad(set_to_none=True)
            loss = _fill_drain_loss(svit, head, cfg, head_type,
                                    normalize_imagenet(images_u8), labels,
                                    plan, hk)
            loss.backward()
            loss = loss.detach()
            _sum_shared_grads(svit, head, [loss], group)
            opt_state.step()
        return loss

    return step


def make_pp_interleaved_train_step(cfg: ViTConfig, head_type: str,
                                   n_classes: int, optimizer, group=None,
                                   n_chunks: int = 2,
                                   n_microbatches: int = 2, waves: int = 1,
                                   use_flash: bool = True,
                                   remat: bool = False,
                                   donate: bool = False) -> Callable:
    """The fill-drain step on the interleaved placement: ``step(svit, head,
    opt_state, images_u8, labels) -> loss``, ``svit`` from
    ``pp_shard_vit(vit, group, n_chunks)``.  Activations wrap the ring V
    times; M <= S keeps one slot per rank and tick, and ``waves=K`` sweeps
    the batch as K slabs of M microbatches with the gradients summed and
    one update on the full-batch mean (the losses and gradients of the K
    sweeps averaged).  mlp/linear heads; ``donate`` as in
    :func:`make_pp_train_step`."""
    if head_type not in ("mlp", "linear"):
        raise ValueError(f"interleaved PP training supports the mlp/linear "
                         f"heads; got {head_type!r} (for head='moe' use "
                         f"the GPipe step make_pp_train_step)")
    n_stages = get_world_size(group)
    if n_microbatches > n_stages:
        raise ValueError(
            f"interleaved schedule needs n_microbatches ({n_microbatches}) "
            f"<= stages ({n_stages}); accumulate gradients over waves for "
            f"more")
    if waves < 1:
        raise ValueError(f"waves must be >= 1, got {waves}")

    def step(svit, head, opt_state, images_u8, labels):
        _check_stage(svit, group, n_chunks)
        b = images_u8.shape[0]
        if b % (waves * n_microbatches):
            raise ValueError(f"batch {b} not divisible by waves x "
                             f"microbatches ({waves} x {n_microbatches})")
        plan = _Plan(_stage_fn(svit, cfg, use_flash, False), group,
                     n_chunks, n_microbatches, remat)
        slab = b // waves
        with matmul_ctx(None):
            opt_state.zero_grad(set_to_none=True)
            x = normalize_imagenet(images_u8)
            loss = torch.zeros((), device=x.device)
            for w in range(waves):
                part = _fill_drain_loss(
                    svit, head, cfg, head_type, x[w * slab:(w + 1) * slab],
                    labels[w * slab:(w + 1) * slab], plan, {})
                part.backward()
                loss += part.detach()
            _sum_shared_grads(svit, head, [loss], group)
            for p in optimizer_params(opt_state):
                if p.grad is not None:
                    p.grad.div_(waves)
            opt_state.step()
        return loss / waves

    return step


# ---------------------------------------------------------------------------
# 1F1B: contiguous (V = 1) and interleaved, one tick table
# ---------------------------------------------------------------------------

def _one_f_one_b(svit: StageViT, head: nn.Module, cfg: ViTConfig,
                 head_type: str, n_classes: int, x: torch.Tensor,
                 labels: torch.Tensor, w: torch.Tensor, w_total, group,
                 n_mb: int, use_flash: bool):
    """The 1F1B ticks of one batch on this rank: accumulates its gradients
    in ``.grad`` and returns (its loss partial, its confusion matrix),
    nonzero on the last stage.  ``x`` (B, H, W, 3) normalized in the
    activation dtype, ``labels`` (B, N), ``w`` per-sample weights,
    ``w_total`` the whole batch's weight total."""
    s, n_st, n_ch = svit.stage, svit.n_stages, svit.n_chunks
    last, n_c = n_st - 1, n_st * svit.n_chunks   # C = S*V chunks
    cap = 2 * n_c                                 # stash ring slots
    g_max, r_max = divmod(n_mb - 1, n_st)
    max_tf = g_max * n_c + (n_ch - 1) * n_st + r_max + last
    n_ticks = max_tf + n_c + 1
    mb = x.shape[0] // n_mb
    n_pat = labels.shape[-1]
    x_mbs = x.reshape((n_mb, mb) + x.shape[1:])
    y_mbs = labels.reshape(n_mb, mb * n_pat).long()
    w_mbs = w.reshape(n_mb, mb).repeat_interleave(n_pat, dim=1)
    n_tok = (x.shape[1] // cfg.patch_size) * (x.shape[2] // cfg.patch_size)
    tok_shape = (mb, n_tok + 1, cfg.embed_dim)
    idle = torch.zeros(tok_shape, dtype=x.dtype, device=x.device)
    ring = torch.empty((cap,) + tok_shape, dtype=x.dtype, device=x.device)
    fwd = _stage_fn(svit, cfg, use_flash, False)
    recv_f = recv_b = dy_pend = None
    loss = torch.zeros((), device=x.device)
    cm = torch.zeros((n_classes, n_classes), dtype=torch.int64,
                     device=x.device)

    def clock(u):
        """(chunk-loop index, microbatch) at lane clock u, or None."""
        if u < 0:
            return None
        g, within = divmod(u, n_c)
        v, r = divmod(within, n_st)
        m = g * n_st + r
        return (v, m) if m < n_mb else None

    for t in range(n_ticks):
        send_f = send_b = y_f = None
        if t <= max_tf:                                   # forward slot
            send_f = idle
            slot = clock(t - s)
            if slot is not None:
                v_f, m_f = slot
                with torch.no_grad():
                    h = (prepare_tokens(svit, x_mbs[m_f], cfg)
                         if s == 0 and v_f == 0 else recv_f)
                    ring[t % cap].copy_(h)
                    y_f = send_f = fwd(v_f, h)
        if t >= n_c:                                      # backward slot
            send_b = idle
            slot = clock(t - n_c - (last - s))
            if slot is not None:
                vp, m_b = slot
                v = n_ch - 1 - vp
                g_in = dy_pend if (s == last and vp == 0) else recv_b
                lag = 2 * (n_c - (v * n_st + s)) - 1
                with torch.enable_grad():
                    if s == 0 and v == 0:  # the embedding's gradient too
                        h = prepare_tokens(svit, x_mbs[m_b], cfg)
                    else:
                        h = ring[(t - lag) % cap].detach().requires_grad_()
                    torch.autograd.backward(fwd(v, h), g_in)
                if not (s == 0 and v == 0):
                    send_b = h.grad
        if s == last and y_f is not None and v_f == n_ch - 1:  # head slot
            with torch.enable_grad():
                y = y_f.detach().requires_grad_()
                feats = y[:, 1:, :].reshape(-1, cfg.embed_dim)
                logp = head_apply(head_type, head,
                                  layer_norm(svit.norm, feats, cfg.ln_eps))
                picked = logp.gather(1, y_mbs[m_f][:, None])[:, 0]
                loss_m = -(picked.float() * w_mbs[m_f]).sum() / w_total
                loss_m.backward()
            dy_pend = y.grad
            loss += loss_m.detach()
            cm += confusion_matrix(logp.detach().argmax(dim=-1), y_mbs[m_f],
                                   n_classes, w_mbs[m_f])
        rf, rb = stage_hop(send_f, send_b, group)
        recv_f = rf if send_f is not None else recv_f
        recv_b = rb if send_b is not None else recv_b
    return loss, cm


def _make_1f1b_step(cfg, head_type, n_classes, group, n_chunks, n_mb,
                    use_flash, compute_dtype) -> Callable:
    if head_type not in ("mlp", "linear"):
        see = " — see the guard comment" if n_chunks == 1 else ""
        raise ValueError(f"1F1B PP training supports the mlp/linear heads; "
                         f"got {head_type!r} (for head='moe' use the GPipe "
                         f"step make_pp_train_step{see})")

    def step(svit, head, opt_state, images_u8, labels, mask=None):
        _check_stage(svit, group, n_chunks)
        b = images_u8.shape[0]
        if b % n_mb:
            raise ValueError(f"batch {b} not divisible by {n_mb} "
                             f"microbatches")
        with matmul_ctx(compute_dtype):
            opt_state.zero_grad(set_to_none=True)
            x = normalize_imagenet(images_u8)
            if compute_dtype is not None:
                x = x.to(compute_dtype)
            w = (torch.ones(b, device=x.device) if mask is None
                 else mask.float())
            # the whole batch's weight total: every microbatch's partial
            # divides by it, so the partials' gradients add up exactly
            w_total = (w.sum() * labels.shape[-1]).clamp_min(1.0)
            loss, cm = _one_f_one_b(svit, head, cfg, head_type, n_classes,
                                    x, labels, w, w_total, group, n_mb,
                                    use_flash)
            _sum_shared_grads(svit, head, [loss, cm], group)
            opt_state.step()
        return loss, cm

    return step


def make_pp_1f1b_train_step(cfg: ViTConfig, head_type: str, n_classes: int,
                            optimizer, group=None, n_microbatches: int = 2,
                            use_flash: bool = True, scan: bool = False,
                            compute_dtype: Optional[torch.dtype] = None,
                            donate: bool = False) -> Callable:
    """PP train step on the hand-written 1F1B schedule (the one ``fit``
    uses): ``step(svit, head, opt_state, images_u8, labels, mask=None) ->
    (loss, cm)``, ``make_train_step``'s contract (a per-sample 0/1
    ``mask`` drops padded samples from the loss, the gradients and the
    confusion matrix; the loss divides by the whole batch's weight total)
    on this rank's contiguous stage (:func:`pp_shard_vit`).  Every rank
    passes the same batch; the (C, C) confusion matrix and the loss come
    from the last stage, summed to every rank.

    Per rank the forward slots run M*per block forwards without a gradient
    (the composition MLP, not the fused kernel), the backward slots
    recompute them from the 2S-slot stash and run M*per backwards, so
    activation memory is O(S) microbatches whatever M is.
    ``compute_dtype=torch.bfloat16`` runs the stages in bf16: the stash,
    both hops and the pending cotangent carry it; the loss sums in f32.
    mlp/linear heads.  ``scan`` and ``donate`` are accepted for
    ``dino_tpu``'s signature: the step runs its tick table in Python and
    updates in place, the same math either way."""
    return _make_1f1b_step(cfg, head_type, n_classes, group, 1,
                           n_microbatches, use_flash, compute_dtype)


def make_pp_interleaved_1f1b_train_step(
        cfg: ViTConfig, head_type: str, n_classes: int, optimizer,
        group=None, n_chunks: int = 2, n_microbatches: int = 2,
        use_flash: bool = True, scan: bool = False,
        compute_dtype: Optional[torch.dtype] = None,
        donate: bool = False) -> Callable:
    """:func:`make_pp_1f1b_train_step` on the interleaved placement
    (``svit`` from ``pp_shard_vit(vit, group, n_chunks)``), any M in one
    schedule: microbatch m = g*S + r runs chunk c = v*S + s forward at tick
    g*C + v*S + r + s and backward at C + g*C + (V-1-v)*S + r + (S-1-s);
    the stash is a ring of 2SV slots.  ``scan``, ``donate`` and
    ``compute_dtype`` as there."""
    return _make_1f1b_step(cfg, head_type, n_classes, group, n_chunks,
                           n_microbatches, use_flash, compute_dtype)


# ---------------------------------------------------------------------------
# DP x PP x TP on the (data, stage, model) grid
# ---------------------------------------------------------------------------

def _pp_tp_tokens(vit: VisionTransformer, x: torch.Tensor, cfg: ViTConfig,
                  stage_group, model_group, n_mb: int, flash: str,
                  remat: bool) -> torch.Tensor:
    """This data slab's normed (b, 1+N, D) tokens on every rank of its
    stage and model groups: the fill-drain over the stage group, each of
    the stage's blocks tensor-parallel over the model group
    (``tp_block_apply`` on this rank's head group, whole-sequence
    attention).  ``vit`` is the standard module: the packing and the slice
    are taken under autograd, so gradients come back in its layout."""
    if flash not in ("auto", "force", "off"):
        raise ValueError(f"flash must be 'auto', 'force' or 'off', got "
                         f"{flash!r}")
    n_st, s = get_world_size(stage_group), get_rank(stage_group)
    t, me = get_world_size(model_group), get_rank(model_group)
    blocks = [vit.blocks[i] for i in
              stage_block_ids(len(vit.blocks), n_st, s)]

    def attn(q, k, v):
        if flash == "off":  # dino_tpu's attention_xla
            return attention_with_probs(q, k, v, cfg.scale)[0]
        return flash_attention(q, k, v, cfg.scale)

    def run(_, h):
        for blk in blocks:
            p = tp_rank_slice(tp_pack_block(blk, cfg), cfg, me, t)
            h = tp_block_apply(p, h, cfg, model_group, attn)
        return h

    plan = _Plan(run, stage_group, 1, n_mb, remat)
    out = _pipelined(prepare_tokens(vit, x, cfg), plan)
    return layer_norm(vit.norm, out, cfg.ln_eps)


def _pp_tp_checks(cfg: ViTConfig, b: int, data_group, model_group,
                  n_mb: int) -> None:
    t, d = get_world_size(model_group), get_world_size(data_group)
    if cfg.num_heads % t or cfg.mlp_hidden % t:
        raise ValueError(f"tensor-parallel degree {t} must divide both "
                         f"num_heads ({cfg.num_heads}) and mlp_hidden "
                         f"({cfg.mlp_hidden})")
    if b % (d * n_mb):
        raise ValueError(f"batch {b} must divide by data-parallel degree x "
                         f"microbatches ({d} x {n_mb})")


def vit_forward_pp_tp(vit: VisionTransformer, x: torch.Tensor,
                      cfg: ViTConfig, data_group=None, stage_group=None,
                      model_group=None, n_microbatches: int = 2,
                      flash: str = "auto", remat: bool = False
                      ) -> torch.Tensor:
    """The ViT forward on the 3-axis composition (``parallel/mesh.py:
    make_grid(model, stage=S)``'s groups): the batch splits over the data
    group, the blocks pipeline over the stage group, every block's math is
    tensor-parallel over the model group.  ``vit`` is the standard module
    and x (B, H, W, 3) normalized, the same on every rank.  Returns the
    normed (B, N+1, D) tokens, each slab gathered over the data group;
    ``vit_forward``'s up to reduction order.  ``flash``: 'auto' and
    'force' take the flash kernel on a CUDA tensor (its plain version on
    the CPU), 'off' the plain attention.  Raises ``dino_tpu``'s errors."""
    b = x.shape[0]
    _pp_tp_checks(cfg, b, data_group, model_group, n_microbatches)
    d, n_d = get_rank(data_group), get_world_size(data_group)
    b_loc = b // n_d
    tok = _pp_tp_tokens(vit, x[d * b_loc:(d + 1) * b_loc], cfg, stage_group,
                        model_group, n_microbatches, flash, remat)
    return all_gather_seq(tok, data_group, dim=0)


def make_dp_pp_tp_train_step(cfg: ViTConfig, head_type: str, n_classes: int,
                             optimizer, data_group=None, stage_group=None,
                             model_group=None, n_microbatches: int = 2,
                             flash: str = "auto",
                             compute_dtype: Optional[torch.dtype] = None,
                             remat: bool = False,
                             donate: bool = False) -> Callable:
    """3D-parallel train step: DP over the data group, GPipe over the stage
    group, Megatron TP over the model group.  ``step(vit, head, opt_state,
    images_u8, labels, mask=None) -> (loss, cm)``, ``make_train_step``'s
    contract with the parameters in the standard layout and one update,
    the same on every rank (``tp.make_composed_train_step``).  Every rank
    passes the whole batch; each rank scores its stage's 1/S chunk of its
    data slab's patch rows.  The gradients of the split weights are summed
    over the model group, then every gradient, the loss and the confusion
    matrix over the data and the stage groups (a block's gradient is
    nonzero on its stage alone).  ``donate`` as in
    :func:`make_pp_train_step`."""
    def features(vit, x):
        b = x.shape[0]
        _pp_tp_checks(cfg, b, data_group, model_group, n_microbatches)
        d, n_d = get_rank(data_group), get_world_size(data_group)
        b_loc = b // n_d
        tok = _pp_tp_tokens(vit, x[d * b_loc:(d + 1) * b_loc], cfg,
                            stage_group, model_group, n_microbatches, flash,
                            remat)
        feats = tok[:, 1:, :].reshape(-1, tok.shape[-1])
        lo, hi = _chunk_rows(feats.shape[0], get_world_size(stage_group),
                             get_rank(stage_group))
        rows = d * feats.shape[0] + torch.arange(lo, hi, device=x.device)
        return feats[lo:hi], rows

    return make_composed_train_step(
        features, "DPxPPxTP", head_type, n_classes, optimizer,
        loss_group=(data_group, stage_group), model_group=model_group,
        compute_dtype=compute_dtype)
