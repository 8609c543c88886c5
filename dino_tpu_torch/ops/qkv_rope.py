"""The qkv epilogue of a RoPE attention layer: bias, rotation, rounding and
the head-major layout, in one pass.

A DINOv3 block (``models/vit.py``) takes qkv's product with a float32
result, y (B * N, 3C) over tokens [prefix tokens, patches], and makes

    t = y + bias          (the k third of the bias held at 0: mask_k_bias)
    q, k of the patch rows (n >= prefix):
        t * cos + rotate_half(t) * sin,  rotate_half(t) = [-t2 | t1]
    out = dtype(t), as (3, B, heads, N, hd): q, k, v head-major

in float32, cos and sin the (N - prefix, hd) table of
``models/vit.py:rope_table``.  On the card ``csrc/qkv_rope.cu`` reads y
once and writes q, k and v once (hd 64, bf16), where eager PyTorch makes a
pass for the bias and one more for each of the rotation's products and
sums, the rounding and the head-major copy.  The plain version is that
composition of PyTorch's operations, the same arithmetic; the kernel adds
and multiplies without fusing (``__fadd_rn``, ``__fmul_rn``), so the two
agree to the bit.  The kernel runs forwards only: a tensor that autograd
would have to differentiate, a CPU tensor, float32 or another head size
takes the plain version.  ``qkv_rope.launches`` counts its launches.
"""
from __future__ import annotations

import torch

from dino_tpu_torch.ops import _build

_HEAD_DIM = 64


def masked_bias(bias: torch.Tensor) -> torch.Tensor:
    """qkv's bias (3C,) as float32 with its k third at 0."""
    c = bias.shape[0] // 3
    b = bias.float().clone()
    b[c:2 * c] = 0.0
    return b


def qkv_rope_plain(y: torch.Tensor, bias: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, batch: int, heads: int, prefix: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """(3, B, heads, N, hd) ``dtype`` from y (B * N, 3C) float32, bias (3C,)
    (its k third not read), cos and sin (N - prefix, hd) float32."""
    rows, c3 = y.shape
    n, hd = rows // batch, c3 // 3 // heads
    t = (y + masked_bias(bias)).reshape(batch, n, 3, heads, hd)
    t = t.permute(2, 0, 3, 1, 4)
    qk = t[:2, :, :, prefix:]
    rot = torch.cat([-qk[..., hd // 2:], qk[..., :hd // 2]], dim=-1)
    qk = qk * cos + rot * sin
    qk = torch.cat([t[:2, :, :, :prefix], qk], dim=3)
    return torch.cat([qk, t[2:]]).to(dtype).contiguous()


def _check(y, bias, cos, sin, batch, heads, prefix) -> None:
    if y.dim() != 2 or y.dtype != torch.float32 or y.shape[0] % batch:
        raise ValueError(f"qkv_rope: y must be (B * N, 3C) float32 over "
                         f"batch {batch}, got {tuple(y.shape)} {y.dtype}")
    n, c3 = y.shape[0] // batch, y.shape[1]
    if c3 != 3 * heads * _HEAD_DIM:
        raise ValueError(f"qkv_rope: the kernel takes 3 x {heads} heads of "
                         f"{_HEAD_DIM} columns, got {c3}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (c3,):
        raise ValueError(f"qkv_rope: bias must be ({c3},) float32")
    for t in (cos, sin):
        if (t.dtype != torch.float32
                or tuple(t.shape) != (n - prefix, _HEAD_DIM)):
            raise ValueError(f"qkv_rope: cos and sin must be "
                             f"({n - prefix}, {_HEAD_DIM}) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if any(t.device != y.device for t in (bias, cos, sin)):
        raise ValueError("qkv_rope: every tensor must be on one device")


def qkv_rope(y: torch.Tensor, bias: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor, batch: int, heads: int, prefix: int,
             dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:func:`qkv_rope_plain`'s result: the kernel for a bf16 result at
    head size 64 on the card with no gradient to take, the plain version
    otherwise."""
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"qkv_rope: unsupported device {y.device}")
    hd = y.shape[1] // 3 // heads
    if (y.device.type == "cpu" or dtype != torch.bfloat16
            or hd != _HEAD_DIM
            or (torch.is_grad_enabled()
                and any(t.requires_grad for t in (y, bias, cos, sin)))):
        return qkv_rope_plain(y, bias, cos, sin, batch, heads, prefix, dtype)
    bias = bias.float()
    _check(y, bias, cos, sin, batch, heads, prefix)
    y, bias = y.contiguous(), bias.contiguous()
    cos, sin = cos.contiguous(), sin.contiguous()
    n = y.shape[0] // batch
    out = torch.empty((3, batch, heads, n, hd), dtype=dtype, device=y.device)
    if y.numel() == 0:
        return out
    rc = _build.library().dtt_qkv_rope(
        y.data_ptr(), bias.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        out.data_ptr(), batch, n, heads, prefix,
        torch.cuda.current_stream(y.device).cuda_stream)
    _build.check_launch("qkv_rope", rc)
    qkv_rope.launches += 1
    return out


qkv_rope.launches = 0
