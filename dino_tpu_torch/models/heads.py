"""Per-patch segmentation heads (MLP / Linear / mixture of experts).

The head is a per-patch map applied after folding all patches onto the batch
axis, ending in log_softmax (float32).  Parameters carry the reference names
``layer_1``..``layer_3`` (nn.Linear, weight (out, in)); init matches
torch.nn.Linear's U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias.

The MoE head (``dino_tpu/models/heads.py``'s, Switch-style top-1 routing)
keeps that per-patch contract: a float32 ``router`` (nn.Linear, E outputs)
picks one of E expert MLPs per patch, whose stacked layers ``layer_1``..
``layer_3`` hold ``weight`` (E, in, out) and ``bias`` (E, out), the expert
axis first as in ``dino_tpu``'s pytree.  The chosen expert's logits are
scaled by its gate probability.  ``moe_head_apply`` runs every expert on
every patch and picks; ``moe_head_apply_sparse`` gathers each expert's
patches into a (E, capacity) table first, capacity ceil(cf * M / E), slots
claimed in batch order, an overflowed patch getting zero logits (the
uniform distribution).  ``moe_balance_loss`` / ``moe_balance_stats`` are
the load-balance auxiliary and its 2E+1 additive statistics.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dino_tpu_torch.precision import true_fp32


class MLPHead(nn.Module):
    def __init__(self, n_classes: int, input_dim: int = 384):
        super().__init__()
        self.layer_1 = nn.Linear(input_dim, 200)
        self.layer_2 = nn.Linear(200, 100)
        self.layer_3 = nn.Linear(100, n_classes)


class LinearHead(nn.Module):
    def __init__(self, n_classes: int, input_dim: int = 384):
        super().__init__()
        self.layer_1 = nn.Linear(input_dim, n_classes)


class ExpertLinear(nn.Module):
    """E stacked dense layers: ``weight`` (E, in, out), ``bias`` (E, out)."""

    def __init__(self, n_experts: int, in_features: int, out_features: int):
        super().__init__()
        self.in_features = in_features
        self.weight = nn.Parameter(torch.empty(n_experts, in_features,
                                               out_features))
        self.bias = nn.Parameter(torch.empty(n_experts, out_features))


class MoEHead(nn.Module):
    def __init__(self, n_classes: int, input_dim: int = 384,
                 n_experts: int = 4):
        super().__init__()
        self.router = nn.Linear(input_dim, n_experts)
        self.layer_1 = ExpertLinear(n_experts, input_dim, 200)
        self.layer_2 = ExpertLinear(n_experts, 200, 100)
        self.layer_3 = ExpertLinear(n_experts, 100, n_classes)


@torch.no_grad()
def init_head(head_type: str, n_classes: int, input_dim: int = 384,
              generator: torch.Generator = None,
              n_experts: int = 4) -> nn.Module:
    if head_type == "mlp":
        head = MLPHead(n_classes, input_dim)
    elif head_type == "linear":
        head = LinearHead(n_classes, input_dim)
    elif head_type == "moe":
        head = MoEHead(n_classes, input_dim, n_experts)
        # a small normal router, so early routing is near-uniform
        nn.init.normal_(head.router.weight, std=0.02, generator=generator)
        nn.init.zeros_(head.router.bias)
    else:
        raise ValueError(f"unknown head {head_type!r}")
    for lin in head.children():
        if head_type == "moe" and lin is head.router:
            continue
        bound = 1.0 / math.sqrt(lin.in_features)
        nn.init.uniform_(lin.weight, -bound, bound, generator=generator)
        nn.init.uniform_(lin.bias, -bound, bound, generator=generator)
    return head


def _linear_once(x2: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 dtype: torch.dtype) -> torch.Tensor:
    """b + x2 @ w^T summed in float32 and rounded once to ``dtype``.  On the
    card the product is one cuBLAS call with a float32 result
    (``mm`` with ``out_dtype``; ``addmm``'s float32-bias form first copies
    the bias over the whole output and reads it back), then one pass adds
    the bias and rounds; on the CPU float32 arithmetic on the same
    operands.  ``b=None``: the product alone (a row-parallel partial,
    summed over the ranks before its bias)."""
    if x2.device.type == "cuda":
        y = torch.mm(x2, w.t(), out_dtype=torch.float32)
        if b is None:
            return y.to(dtype)
        out = y if dtype == torch.float32 else torch.empty_like(y,
                                                                dtype=dtype)
        return torch.add(y, b, out=out)
    if x2.device.type == "cpu":
        y = F.linear(x2.float(), w.float())
        return (y if b is None else y + b).to(dtype)
    raise ValueError(f"linear_once: unsupported device {x2.device}")


class _LinearOnce(torch.autograd.Function):
    """:func:`_linear_once` under autograd.  The backward takes the
    cotangent rounded to the operands' dtype, as ``F.linear``'s backward
    and the JAX VJP of ``dense`` (whose cotangent comes through its cast)
    do: dx and dw in that dtype with float32 accumulation, db summed in
    float32."""

    @staticmethod
    def forward(ctx, x2, w, b, dtype):
        ctx.save_for_backward(x2, w)
        return _linear_once(x2, w, b, dtype)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        gl = g.to(x2.dtype)
        return (gl @ w if ctx.needs_input_grad[0] else None,
                gl.t() @ x2 if ctx.needs_input_grad[1] else None,
                g.float().sum(0) if ctx.needs_input_grad[2] else None, None)


def linear_once(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
    """x @ w^T + b for x, w in a low-precision dtype (bf16): the product
    accumulated in float32, the float32 bias added, and one rounding to
    ``dtype`` (float32: none), as ``dino_tpu``'s ``jnp.dot(x, w,
    preferred_element_type=float32) + b`` and its cast.  ``b=None``: the
    product alone."""
    b = b.float() if b is not None else None
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or (b is not None and b.requires_grad)):
        y = _LinearOnce.apply(x2, w, b, dtype)
    else:
        y = _linear_once(x2, w, b, dtype)
    return y.reshape(*x.shape[:-1], w.shape[0])


def affine(lin: nn.Linear, x: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``dino_tpu``'s head ``_affine``: x @ W^T + bias in float32, rounded
    once to ``dtype`` (float32: not at all).  float32 inputs keep their
    earlier form (``F.linear``, then the bias)."""
    return affine_t(x, lin.weight, lin.bias, dtype)


def affine_t(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor],
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`affine` of a weight (out, in) and bias given as tensors;
    ``bias=None`` returns the float32 product alone."""
    w = weight.to(x.dtype)
    if x.dtype == torch.float32:
        y = F.linear(x, w)
        return y if bias is None else (y + bias.float()).to(dtype)
    return linear_once(x, w, bias, dtype)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: torch.Tensor) -> torch.Tensor:
    """``dino_tpu``'s ``dense``: x @ weight^T + bias, rounded once to x's
    dtype after the float32 bias add.  float32 keeps its earlier form
    (``F.linear`` with the bias)."""
    w = weight.to(x.dtype)
    if x.dtype == torch.float32:
        return F.linear(x, w, bias.to(x.dtype))
    return linear_once(x, w, bias, x.dtype)


def mlp_head_apply(head: MLPHead, x: torch.Tensor) -> torch.Tensor:
    """(M, input_dim) -> (M, n_classes) log-probabilities."""
    x = torch.relu(affine(head.layer_1, x, x.dtype))
    x = torch.relu(affine(head.layer_2, x, x.dtype))
    return torch.log_softmax(affine(head.layer_3, x), dim=-1)


def linear_head_apply(head: LinearHead, x: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(affine(head.layer_1, x), dim=-1)


# ---------------------------------------------------------------------------
# Mixture-of-experts head
# ---------------------------------------------------------------------------

def _bmm_once(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """b[:, None] + h @ w per expert, summed in float32 and rounded once to
    ``dtype``: on the card one batched cuBLAS product with a float32 result
    (``bmm`` with ``out_dtype``) and one pass for the bias and the rounding;
    on the CPU float32 arithmetic on the same operands."""
    if h.device.type == "cuda":
        y = torch.bmm(h, w, out_dtype=torch.float32)
    elif h.device.type == "cpu":
        y = torch.bmm(h.float(), w.float())
    else:
        raise ValueError(f"bmm_once: unsupported device {h.device}")
    out = y if dtype == torch.float32 else torch.empty_like(y, dtype=dtype)
    return torch.add(y, b[:, None, :], out=out)


class _BmmOnce(torch.autograd.Function):
    """:func:`_bmm_once` under autograd, with :class:`_LinearOnce`'s
    backward: the cotangent rounded to the operands' dtype, dh and dw in
    that dtype with float32 accumulation, db summed in float32."""

    @staticmethod
    def forward(ctx, h, w, b, dtype):
        ctx.save_for_backward(h, w)
        return _bmm_once(h, w, b, dtype)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        gl = g.to(h.dtype)
        return (torch.bmm(gl, w.transpose(1, 2))
                if ctx.needs_input_grad[0] else None,
                torch.bmm(h.transpose(1, 2), gl)
                if ctx.needs_input_grad[1] else None,
                g.float().sum(1) if ctx.needs_input_grad[2] else None, None)


def expert_affine(layer: ExpertLinear, h: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(E, M, in) -> (E, M, out): each expert's h @ W + b in float32,
    rounded once to ``dtype``, as ``dino_tpu``'s ``expert_affine`` (an
    einsum with a float32 result, then the float32 bias) and its cast."""
    b = layer.bias.float()
    if h.dtype == torch.float32:
        return (torch.bmm(h, layer.weight.float()) + b[:, None, :]).to(dtype)
    w = layer.weight.to(h.dtype)
    if torch.is_grad_enabled() and (h.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return _BmmOnce.apply(h, w, b, dtype)
    return _bmm_once(h, w, b, dtype)


def moe_gate(head: MoEHead, x: torch.Tensor) -> torch.Tensor:
    """(M, D) -> (M, E) router probabilities, float32.  The router runs in
    true float32 (TF32 off) on every precision route: a TF32 router on the
    card would flip top-1 choices against the CPU."""
    r = head.router
    with true_fp32():
        logits = F.linear(x.float(), r.weight.float()) + r.bias.float()
    return torch.softmax(logits, dim=-1)


def _top1(gate: torch.Tensor):
    """(best expert (M,), its gate probability (M, 1)); argmax takes the
    first maximum, as ``jnp.argmax``."""
    best = gate.argmax(dim=-1)
    return best, gate.gather(1, best[:, None])


def moe_balance_stats(head: MoEHead, x: torch.Tensor,
                      weights: Optional[torch.Tensor] = None):
    """(sum of routed one-hots * w (E,), sum of gate probs * w (E,), sum of
    w): the 2E+1 statistics behind :func:`moe_balance_loss`.  They add
    exactly across microbatches and token shards; the gradient flows only
    through the gate-prob sums."""
    gate = moe_gate(head, x)
    one_hot = F.one_hot(gate.argmax(dim=-1), gate.shape[-1]).float()
    if weights is None:
        return (one_hot.sum(0), gate.sum(0),
                torch.tensor(float(x.shape[0]), device=x.device))
    w = weights.float()[:, None]
    return (one_hot * w).sum(0), (gate * w).sum(0), w.sum()


def moe_balance_loss(head: MoEHead, x: torch.Tensor,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Switch load-balance auxiliary E * sum_e f_e * P_e (f: the fraction of
    patches routed to e, P: the mean gate probability), 1 at uniform
    routing.  ``weights`` (M,) leaves padded patches out."""
    gate = moe_gate(head, x)
    n_experts = gate.shape[-1]
    one_hot = F.one_hot(gate.argmax(dim=-1), n_experts).float()
    if weights is None:
        f, pbar = one_hot.mean(0), gate.mean(0)
    else:
        w = weights.float()[:, None]
        denom = w.sum().clamp_min(1.0)
        f, pbar = (one_hot * w).sum(0) / denom, (gate * w).sum(0) / denom
    return n_experts * (f * pbar).sum()


def _experts(head: MoEHead, h: torch.Tensor, dtype: torch.dtype):
    """The three expert layers over (E, rows, D) -> (E, rows, C) float32."""
    h = torch.relu(expert_affine(head.layer_1, h, dtype))
    h = torch.relu(expert_affine(head.layer_2, h, dtype))
    return expert_affine(head.layer_3, h)


def moe_head_apply(head: MoEHead, x: torch.Tensor) -> torch.Tensor:
    """(M, D) -> (M, C) log-probs by top-1 routing, every expert computing
    every patch and the routed expert's logits picked (``dino_tpu``'s
    one-hot combine: one nonzero term per row, so a pick gives its bits)."""
    gate = moe_gate(head, x)
    best, top_w = _top1(gate)
    n_experts, m = gate.shape[-1], x.shape[0]
    y = _experts(head, x.expand(n_experts, *x.shape), x.dtype)  # (E, M, C)
    out = y.permute(1, 0, 2)[torch.arange(m, device=x.device), best]
    return torch.log_softmax(out * top_w, dim=-1)


def moe_capacity_of(m: int, n_experts: int, capacity_factor: float) -> int:
    return max(1, int(math.ceil(capacity_factor * m / n_experts)))


def moe_head_apply_sparse(head: MoEHead, x: torch.Tensor,
                          capacity_factor: float = 1.25) -> torch.Tensor:
    """(M, D) -> (M, C) log-probs by capacity-bounded top-1 dispatch: each
    expert computes only its routed patches, at most ceil(cf * M / E),
    claimed in batch order; an overflowed patch gets zero logits (the
    uniform distribution).  With cf >= E nothing drops and the result is
    :func:`moe_head_apply`'s.

    The (E, capacity) table of patch ids is built with no host sync: a
    patch's flat slot best * capacity + arrival, overflow sent to one spare
    entry, empty slots holding the sentinel M (a zero row).  The combine
    adds the results into M + 1 rows; every real row receives at most one
    addend, so ``index_add_`` keeps the bits."""
    gate = moe_gate(head, x)
    best, top_w = _top1(gate)
    idx = moe_dispatch_table(best, gate.shape[-1], capacity_factor)
    return torch.log_softmax(moe_combine_sparse(head, x, idx) * top_w,
                             dim=-1)


def moe_dispatch_table(best: torch.Tensor, n_experts: int,
                       capacity_factor: float) -> torch.Tensor:
    """(E, capacity) patch ids of each expert's slots from the top-1 choices
    ``best`` (M,): slots claimed in batch order, empty slots holding the
    sentinel M (see :func:`moe_head_apply_sparse`)."""
    m = best.shape[0]
    cap = moe_capacity_of(m, n_experts, capacity_factor)
    one_hot = F.one_hot(best, n_experts)
    slot = (one_hot.cumsum(0) - 1).gather(1, best[:, None])[:, 0]
    flat = torch.where(slot < cap, best * cap + slot,
                       torch.full_like(slot, n_experts * cap))
    idx = torch.full((n_experts * cap + 1,), m, dtype=torch.int64,
                     device=best.device)
    idx.scatter_(0, flat, torch.arange(m, device=best.device))
    return idx[:-1].reshape(n_experts, cap)


def moe_combine_sparse(head: MoEHead, x: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """(M, C) float32 logits of ``head``'s experts over the patches of their
    slot rows ``idx`` (E_head, capacity), each patch's expert logits added
    into its row (zero where no slot of these experts holds it)."""
    m = x.shape[0]
    x_pad = torch.cat([x, x.new_zeros(1, x.shape[1])])
    y = _experts(head, x_pad[idx], x.dtype)                   # (E, cap, C)
    out = torch.zeros(m + 1, y.shape[-1], device=x.device).index_add_(
        0, idx.reshape(-1), y.reshape(-1, y.shape[-1]))
    return out[:m]


def head_apply(head_type: str, head: nn.Module, x: torch.Tensor,
               moe_dispatch: str = "dense",
               moe_capacity: float = 1.25) -> torch.Tensor:
    if head_type == "mlp":
        return mlp_head_apply(head, x)
    if head_type == "linear":
        return linear_head_apply(head, x)
    if head_type == "moe":
        if moe_dispatch == "sparse":
            return moe_head_apply_sparse(head, x, moe_capacity)
        if moe_dispatch != "dense":
            raise ValueError(f"unknown moe_dispatch {moe_dispatch!r}")
        return moe_head_apply(head, x)
    raise ValueError(f"unknown head {head_type!r}")
