"""Per-patch segmentation heads (MLP / Linear).

The head is a per-patch map applied after folding all patches onto the batch
axis, ending in log_softmax (float32).  Parameters carry the reference names
``layer_1``..``layer_3`` (nn.Linear, weight (out, in)); init matches
torch.nn.Linear's U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

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


@torch.no_grad()
def init_head(head_type: str, n_classes: int, input_dim: int = 384,
              generator: torch.Generator = None) -> nn.Module:
    if head_type == "mlp":
        head = MLPHead(n_classes, input_dim)
    elif head_type == "linear":
        head = LinearHead(n_classes, input_dim)
    elif head_type == "moe":
        raise NotImplementedError("the MoE head is not ported yet (ROADMAP "
                                  "'Modules to port' item 8)")
    else:
        raise ValueError(f"unknown head {head_type!r}")
    for lin in head.children():
        bound = 1.0 / math.sqrt(lin.in_features)
        nn.init.uniform_(lin.weight, -bound, bound, generator=generator)
        nn.init.uniform_(lin.bias, -bound, bound, generator=generator)
    return head


def _linear_once(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """b + x2 @ w^T summed in float32 and rounded once to ``dtype``.  On the
    card the product is one cuBLAS call with a float32 result
    (``mm`` with ``out_dtype``; ``addmm``'s float32-bias form first copies
    the bias over the whole output and reads it back), then one pass adds
    the bias and rounds; on the CPU float32 arithmetic on the same
    operands."""
    if x2.device.type == "cuda":
        y = torch.mm(x2, w.t(), out_dtype=torch.float32)
        out = y if dtype == torch.float32 else torch.empty_like(y,
                                                                dtype=dtype)
        return torch.add(y, b, out=out)
    if x2.device.type == "cpu":
        return (F.linear(x2.float(), w.float()) + b).to(dtype)
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


def linear_once(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """x @ w^T + b for x, w in a low-precision dtype (bf16): the product
    accumulated in float32, the float32 bias added, and one rounding to
    ``dtype`` (float32: none), as ``dino_tpu``'s ``jnp.dot(x, w,
    preferred_element_type=float32) + b`` and its cast."""
    b = b.float()
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        y = _LinearOnce.apply(x2, w, b, dtype)
    else:
        y = _linear_once(x2, w, b, dtype)
    return y.reshape(*x.shape[:-1], w.shape[0])


def affine(lin: nn.Linear, x: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``dino_tpu``'s head ``_affine``: x @ W^T + bias in float32, rounded
    once to ``dtype`` (float32: not at all).  float32 inputs keep their
    earlier form (``F.linear``, then the bias)."""
    w = lin.weight.to(x.dtype)
    if x.dtype == torch.float32:
        return (F.linear(x, w) + lin.bias.float()).to(dtype)
    return linear_once(x, w, lin.bias, dtype)


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


def head_apply(head_type: str, head: nn.Module,
               x: torch.Tensor) -> torch.Tensor:
    if head_type == "mlp":
        return mlp_head_apply(head, x)
    if head_type == "linear":
        return linear_head_apply(head, x)
    raise ValueError(f"unknown head {head_type!r}")
