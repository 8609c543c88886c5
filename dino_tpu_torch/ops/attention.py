"""Attention: the flash-attention forward kernel and its plain version.

``flash_attention`` is the port of ``dino_tpu/ops/attention.py``'s Pallas
online-softmax kernel (``_flash_kernel`` via ``flash_attention``).  On a CUDA
tensor it launches ``csrc/flash_attn_fwd.cu``; on a CPU tensor it runs
``attention_plain``, the same function in plain PyTorch.

Numerics (shared by the kernel and the plain version): scores S = Q.K^T
accumulate in float32 and are scaled after the product; P is rounded to the
input dtype before P.V; O = acc / max(l, 1e-30) in the input dtype; the row
log-sum-exp is m + log(max(l, 1e-30)) in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from dino_tpu_torch.ops import _build

_HEAD_DIM = 64
_DTYPES = (torch.bfloat16, torch.float32)
# rows of queries per chunk of the plain version: bounds its (chunk, N) f32
# score matrix to ~1 GB at any sequence length
_PLAIN_SCORE_ELEMS = 1 << 28


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float):
    """(B, nh, N, hd) -> (out (B, nh, N, hd), lse (B*nh, N) float32)."""
    b, nh, n, hd = q.shape
    kf = k.float()
    vf = v.float()
    chunk = max(1, _PLAIN_SCORE_ELEMS // max(1, b * nh * n))
    outs, lses = [], []
    for i in range(0, n, chunk):
        s = torch.matmul(q[:, :, i:i + chunk].float(), kf.transpose(-1, -2))
        s = s * scale
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        acc = torch.matmul(p.to(q.dtype).float(), vf)
        outs.append((acc / l).to(q.dtype))
        lses.append((m + torch.log(l))[..., 0])
    out = torch.cat(outs, dim=2)
    lse = torch.cat(lses, dim=2).reshape(b * nh, n)
    return out, lse


def check_flash_args(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> None:
    """Raise ValueError on anything the CUDA kernel does not take."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, nh, N, hd), got shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernel takes bf16 or f32 q/k/v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] != _HEAD_DIM:
        raise ValueError(f"flash kernel takes head dim {_HEAD_DIM}, got "
                         f"{q.shape[-1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if t.device != q.device:
            raise ValueError("q, k, v must be on one device")
    if q.shape[2] == 0 or q.shape[0] * q.shape[1] == 0:
        raise ValueError("empty attention input")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, return_lse: bool = False):
    """Flash attention over (B, nh, N, hd) -> (B, nh, N, hd).

    With ``return_lse`` also returns the row log-sum-exp, (B*nh, N) float32.
    A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`attention_plain`; any other device raises.
    """
    if q.device.type == "cpu":
        out, lse = attention_plain(q, k, v, scale)
        return (out, lse) if return_lse else out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    check_flash_args(q, k, v)
    b, nh, n, hd = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b * nh, n), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = _build.library()
    rc = lib.dtt_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b * nh, n, hd, int(q.dtype == torch.bfloat16), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("flash_attn_fwd", rc)
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def multi_head_attention(attn, x: torch.Tensor, *, num_heads: int,
                         scale: float) -> torch.Tensor:
    """Eval-path MHSA: qkv projection -> flash attention -> out projection.

    ``attn`` holds ``qkv`` and ``proj`` (nn.Linear, reference names).  q, k,
    v come out head-major, (B, nh, N, hd) each and contiguous.
    """
    b, n, c = x.shape
    hd = c // num_heads
    qkv = F.linear(x, attn.qkv.weight.to(x.dtype), attn.qkv.bias.to(x.dtype))
    qkv = qkv.reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    qkv = qkv.contiguous()
    out = flash_attention(qkv[0], qkv[1], qkv[2], scale)
    out = out.permute(0, 2, 1, 3).reshape(b, n, c)
    return F.linear(out, attn.proj.weight.to(x.dtype),
                    attn.proj.bias.to(x.dtype))
