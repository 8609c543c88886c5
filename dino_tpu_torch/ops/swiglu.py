"""SwiGLU's epilogue: both biases, silu(a) * b and one rounding, in one pass.

A DINOv3 block's MLP (``models/vit.py:swiglu_mlp_residual``) takes w1 and
w2 as one product over their concatenation, (D -> 2H), with a float32
result ``y``: its first H columns are w1's a, the last H w2's b.  Then

    h = bf16(silu(a + b1) * (b + b2))

in float32, silu(x) = x / (1 + exp(-x)) as PyTorch computes it.  On the
card ``csrc/swiglu.cu`` reads y once and writes h once, where eager
PyTorch makes five passes over (rows, H) tensors; the plain version is
that composition of PyTorch's own operations.  The kernel runs forwards
only: a CUDA tensor that autograd would have to differentiate, a CPU
tensor or another dtype takes the plain version (the same arithmetic).
``swiglu.launches`` counts the kernel's launches.

:func:`fused_weights` gives the product's weight and the two biases
concatenated, cached on the MLP module in the compute dtype while the
weights stay as they are (``utils/weights.py:weights_key``), so a predict
call makes no copy of them; under autograd it concatenates afresh.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from dino_tpu_torch.ops import _build
from dino_tpu_torch.utils.weights import watch_optimizer_steps, weights_key

_VEC = 8  # columns a thread of the kernel takes (one 16-byte bf16 vector)


def swiglu_plain(y: torch.Tensor, b12: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """``dtype``(silu(a + b1) * (b + b2)) of y = [a | b] (rows, 2H) float32
    and b12 = [b1 | b2] (2H,) float32."""
    h = y.shape[-1] // 2
    return (F.silu(y[..., :h] + b12[:h]) * (y[..., h:] + b12[h:])).to(dtype)


def _check(y: torch.Tensor, b12: torch.Tensor) -> None:
    if y.dim() != 2 or y.dtype != torch.float32:
        raise ValueError(f"swiglu: y must be (rows, 2H) float32, got "
                         f"{tuple(y.shape)} {y.dtype}")
    if y.shape[1] % (2 * _VEC):
        raise ValueError(f"swiglu: 2H = {y.shape[1]} is not a multiple of "
                         f"{2 * _VEC}")
    if b12.dtype != torch.float32 or tuple(b12.shape) != (y.shape[1],):
        raise ValueError(f"swiglu: b12 must be ({y.shape[1]},) float32, got "
                         f"{tuple(b12.shape)} {b12.dtype}")
    if b12.device != y.device:
        raise ValueError("swiglu: y and b12 must be on one device")


def swiglu(y: torch.Tensor, b12: torch.Tensor,
           dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(rows, H) ``dtype`` from y (rows, 2H) float32: the kernel for a bf16
    result on the card with no gradient to take, the plain version
    otherwise."""
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"swiglu: unsupported device {y.device}")
    if (y.device.type == "cpu" or dtype != torch.bfloat16
            or (torch.is_grad_enabled()
                and (y.requires_grad or b12.requires_grad))):
        return swiglu_plain(y, b12, dtype)
    _check(y, b12)
    y, b12 = y.contiguous(), b12.contiguous()
    rows, hidden = y.shape[0], y.shape[1] // 2
    h = torch.empty((rows, hidden), dtype=dtype, device=y.device)
    if rows == 0:
        return h
    rc = _build.library().dtt_swiglu(
        y.data_ptr(), b12.data_ptr(), h.data_ptr(), rows, hidden,
        torch.cuda.current_stream(y.device).cuda_stream)
    _build.check_launch("swiglu", rc)
    swiglu.launches += 1
    return h


swiglu.launches = 0


def fused_weights(mlp, dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w12 (2H, D) in ``dtype``, b12 (2H,) float32): ``mlp``'s w1 and w2
    (a ``models/vit.py:SwiGLUFFN``) stacked, as the one product takes them.
    Cached on ``mlp`` by :func:`weights_key` and ``dtype`` unless autograd
    would differentiate them."""
    w1, w2 = mlp.w1, mlp.w2
    if torch.is_grad_enabled() and any(p.requires_grad
                                       for p in mlp.parameters()):
        return (torch.cat([w1.weight, w2.weight]).to(dtype),
                torch.cat([w1.bias, w2.bias]).float())
    watch_optimizer_steps()
    key = (weights_key(mlp), dtype)
    cached = getattr(mlp, "_fused", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            w12 = torch.cat([w1.weight.to(dtype), w2.weight.to(dtype)])
            b12 = torch.cat([w1.bias, w2.bias]).float()
        mlp._fused = cached = (key, (w12, b12))
    return cached[1]
