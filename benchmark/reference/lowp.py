"""Products in float32 or, for the control, in fp8.

``matmul(a, b, fp8)`` is ``a @ b`` in float32; with ``fp8`` both operands
are rounded to float8 e4m3 with one scale per tensor (its largest
magnitude to 448, e4m3's largest finite value), as an fp8 GEMM takes them,
and the product accumulates in float32.  Under autograd the backward's
products take the cotangent rounded the same way, as an fp8 training step
does.  The control is the reference computed so: the step below bf16
that would tempt a later change.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under one per-tensor scale, back in float32."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    return (t.float() * scale).to(torch.float8_e4m3fn).float() / scale


class _FP8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def matmul(a: torch.Tensor, b: torch.Tensor, fp8: bool = False
           ) -> torch.Tensor:
    """``a @ b`` (same batch shape, no broadcasting under ``fp8``)."""
    if fp8:
        return _FP8MatMul.apply(a, b)
    return a @ b


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           fp8: bool = False) -> torch.Tensor:
    """x @ w.T + b over the last axis of ``x``; ``w`` is (out, in)."""
    y = matmul(x.reshape(-1, x.shape[-1]), w.t(), fp8) + b
    return y.reshape(*x.shape[:-1], w.shape[0])
