"""fc1 with its bias, true-erf GELU and one rounding, for bf16 training.

``fc1_bias_gelu(x, w1, b1)`` is ``h = bf16(gelu(x @ w1^T + b1))`` with the
numerics of :func:`dino_tpu_torch.models.vit.mlp_residual`'s composition
(and of ``dino_tpu``'s ``_xla_reference``): the product accumulated in
float32, the float32 bias added, the exact-erf GELU in float32 and one
rounding.  On the card the product is cuBLAS's ``mm`` with a float32
result, as :func:`dino_tpu_torch.models.heads.linear_once` takes it, and
what follows it is ``csrc/bias_gelu.cu``: one pass forward (y read, h
written) and one backward (dh and y read, du written, db summed without
atomics), where eager PyTorch makes four passes each way over the
(rows, hidden) tensor.  XLA fuses that composition in ``dino_tpu``, so the
kernel replaces no Pallas kernel.

:class:`BiasGelu` is the ``torch.autograd.Function``: it saves x, w1, the
raw float32 product y and b1 (the composition saves the GELU's float32
input instead, of the same size), recomputes ``u = y + b1`` in the backward
and returns ``dx = du @ w1``, ``dw1 = du^T @ x`` (du rounded to bf16, as
``_LinearOnce``'s backward rounds its cotangent) and ``db1`` in float32.
A CPU tensor takes the plain versions, the composition's own operations;
a CUDA tensor launches the kernels; any other device raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from dino_tpu_torch.models.heads import _linear_once
from dino_tpu_torch.ops import _build

_VEC = 8  # columns a thread of the kernels takes (one 16-byte bf16 vector)


def applies(x: torch.Tensor, hidden: int) -> bool:
    """Whether the MLP's fc1 over ``x`` takes the kernels: a bf16 tensor on
    the card and a hidden width the kernels' 8-column vectors divide,
    whether or not a gradient is needed."""
    return x.is_cuda and x.dtype == torch.bfloat16 and hidden % _VEC == 0


def bias_gelu_fwd_plain(y: torch.Tensor, b1: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    """``gelu(y + b1)`` in float32, rounded once to ``dtype``."""
    return F.gelu(y + b1, approximate="none").to(dtype)


def bias_gelu_bwd_plain(dh: torch.Tensor, y: torch.Tensor,
                        b1: torch.Tensor):
    """(du rounded to dh's dtype, db1 in float32) of :func:`bias_gelu_fwd_plain`
    for the cotangent ``dh``: GELU's backward in float32 and the float32
    column sum."""
    du = torch.ops.aten.gelu_backward(dh.float(), y + b1, approximate="none")
    return du.to(dh.dtype), du.sum(0)


def _check(name: str, y: torch.Tensor, b1: torch.Tensor) -> None:
    if y.dim() != 2 or y.dtype != torch.float32:
        raise ValueError(f"{name}: y must be (rows, hidden) float32, got "
                         f"{tuple(y.shape)} {y.dtype}")
    if y.shape[1] % _VEC:
        raise ValueError(f"{name}: hidden {y.shape[1]} is not a multiple of "
                         f"{_VEC}")
    if b1.dtype != torch.float32 or tuple(b1.shape) != (y.shape[1],):
        raise ValueError(f"{name}: b1 must be ({y.shape[1]},) float32, got "
                         f"{tuple(b1.shape)} {b1.dtype}")
    if b1.device != y.device:
        raise ValueError(f"{name}: y and b1 must be on one device")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, at a 16-byte aligned address (a parameter FSDP
    gathered is a view into its unit's flat buffer, at any offset)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def bias_gelu_fwd(y: torch.Tensor, b1: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """h = ``dtype``(gelu(y + b1)) of fc1's float32 product y (rows,
    hidden): the kernel for a CUDA tensor (bf16 only), the plain version
    for a CPU tensor."""
    if y.device.type == "cpu":
        return bias_gelu_fwd_plain(y, b1, dtype)
    if y.device.type != "cuda":
        raise ValueError(f"bias_gelu_fwd: unsupported device {y.device}")
    _check("bias_gelu_fwd", y, b1)
    if dtype != torch.bfloat16:
        raise ValueError(f"bias_gelu_fwd: the kernel rounds to bf16, not "
                         f"{dtype}")
    y, b1 = _aligned(y), _aligned(b1)
    h = torch.empty(y.shape, dtype=dtype, device=y.device)
    if y.numel() == 0:
        return h
    rc = _build.library().dtt_bias_gelu_fwd(
        y.data_ptr(), b1.data_ptr(), h.data_ptr(), y.shape[0], y.shape[1],
        torch.cuda.current_stream(y.device).cuda_stream)
    _build.check_launch("bias_gelu_fwd", rc)
    fc1_bias_gelu.launches += 1
    return h


def bias_gelu_bwd(dh: torch.Tensor, y: torch.Tensor, b1: torch.Tensor):
    """(du, db1) of :func:`bias_gelu_fwd` for the cotangent ``dh`` (rows,
    hidden): the kernel and its partial sums' reduction for a CUDA tensor
    (bf16), the plain version for a CPU tensor."""
    if y.device.type == "cpu":
        return bias_gelu_bwd_plain(dh, y, b1)
    if y.device.type != "cuda":
        raise ValueError(f"bias_gelu_bwd: unsupported device {y.device}")
    _check("bias_gelu_bwd", y, b1)
    if dh.dtype != torch.bfloat16 or dh.shape != y.shape \
            or dh.device != y.device:
        raise ValueError(f"bias_gelu_bwd: dh must be bf16 {tuple(y.shape)} "
                         f"on {y.device}, got {dh.dtype} {tuple(dh.shape)} "
                         f"on {dh.device}")
    rows, hidden = y.shape
    du = torch.empty_like(dh, memory_format=torch.contiguous_format)
    if rows == 0:
        return du, torch.zeros(hidden, device=y.device)
    lib = _build.library()
    slabs = lib.dtt_bias_gelu_slabs(rows, hidden)
    if slabs < 0:
        _build.check_launch("bias_gelu_slabs", -slabs)
    dh, y, b1 = _aligned(dh), _aligned(y), _aligned(b1)
    partial = torch.empty(slabs, hidden, device=y.device)
    db = torch.empty(hidden, device=y.device)
    rc = lib.dtt_bias_gelu_bwd(
        dh.data_ptr(), y.data_ptr(), b1.data_ptr(), du.data_ptr(),
        partial.data_ptr(), db.data_ptr(), rows, hidden, slabs,
        torch.cuda.current_stream(y.device).cuda_stream)
    _build.check_launch("bias_gelu_bwd", rc)
    fc1_bias_gelu.launches_bwd += 1
    return du, db


class BiasGelu(torch.autograd.Function):
    """bf16(gelu(x2 @ w1^T + b1)) for x2 (rows, in), w1 (hidden, in) in
    bf16 and b1 (hidden,) float32."""

    @staticmethod
    def forward(ctx, x2, w1, b1):
        y = _linear_once(x2, w1, None, torch.float32)  # unrounded
        ctx.save_for_backward(x2, w1, y, b1)
        return bias_gelu_fwd(y, b1, x2.dtype)

    @staticmethod
    def backward(ctx, dh):
        x2, w1, y, b1 = ctx.saved_tensors
        du, db = bias_gelu_bwd(dh, y, b1)
        return (du @ w1 if ctx.needs_input_grad[0] else None,
                du.t() @ x2 if ctx.needs_input_grad[1] else None,
                db if ctx.needs_input_grad[2] else None)


def fc1_bias_gelu(x: torch.Tensor, w1: torch.Tensor,
                  b1: torch.Tensor) -> torch.Tensor:
    """x (..., in) and w1 (hidden, in) in bf16, b1 (hidden,) -> (...,
    hidden) bf16: :class:`BiasGelu` where autograd needs it, its forward
    alone otherwise (the same bits either way)."""
    b1 = b1.float()
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w1.requires_grad
                                    or b1.requires_grad):
        h = BiasGelu.apply(x2, w1, b1)
    else:
        h = bias_gelu_fwd(_linear_once(x2, w1, None, torch.float32), b1,
                          x.dtype)
    return h.reshape(*x.shape[:-1], w1.shape[0])


fc1_bias_gelu.launches = 0      # forward kernel launches
fc1_bias_gelu.launches_bwd = 0  # backward calls (kernel and its reduction)
