"""Attention: the flash-attention kernels and their plain versions.

``flash_attention`` is the port of ``dino_tpu/ops/attention.py``'s Pallas
``flash_attention``: its forward (``_flash_kernel``, and ``_flash_kernel_chunked``
past the JAX package's 8 resident K/V slices: the CUDA forward streams K/V at
any N) and, under autograd, its backward (``_flash_bwd_kernel``, through
:class:`FlashAttention`).  ``flash_attention_with_lse_dyn`` and
``flash_attention_bwd_dyn`` are the ring-attention hop kernels
(``_flash_kernel_dyn``, ``_flash_bwd_kernel_dyn``): keys at positions >=
``valid_k``, a host int, are masked.  On CUDA tensors they launch
``csrc/flash_attn_fwd.cu`` and ``csrc/flash_attn_bwd.cu``; on CPU tensors
they run the plain PyTorch versions of the same functions.
``attention_probs`` and ``attention_with_probs`` are the materialized
probabilities path (attention maps, the masked-CLS forward, attention
dropout): plain matmuls and a softmax on every device, as in ``dino_tpu``.

Forward numerics (kernel and plain version): scores S = Q.K^T accumulate in
float32 and are scaled after the product; P is rounded to the input dtype
before P.V; O = acc / max(l, 1e-30) in the input dtype; the row log-sum-exp
is m + log(max(l, 1e-30)) in float32.

Backward numerics: P = exp(S*scale - lse) in float32 from the forward's
lse; dV = cast(P)^T.dO; dP = dO.V^T; dS = cast(P*(dP - D)*scale) with
D = rowsum(dO*O) in float32; dK = dS^T.Q; dQ = dS.K; float32 accumulation,
dq, dk, dv in float32, cast to the input dtype by the autograd rule.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from dino_tpu_torch.models.heads import dense
from dino_tpu_torch.ops.quant import QuantLinear, int8_dense
from dino_tpu_torch.ops import _build

_HEAD_DIM = 64
_DTYPES = (torch.bfloat16, torch.float32)
_NEG_INF = -1e30  # the kernels' mask value: exp of it is 0, and never NaN
# rows of queries per chunk of the plain versions: bounds each (chunk, N) f32
# score-sized matrix to ~1 GB at any sequence length
_PLAIN_SCORE_ELEMS = 1 << 28


def _plain_chunk(b: int, nh: int, n: int) -> int:
    return max(1, _PLAIN_SCORE_ELEMS // max(1, b * nh * n))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float):
    """q (B, nh, Nq, hd), k/v (B, nh, Nk, hd) -> (out (B, nh, Nq, hd),
    lse (B*nh, Nq) float32)."""
    b, nh, n, hd = q.shape
    kf = k.float()
    vf = v.float()
    chunk = _plain_chunk(b, nh, k.shape[2])
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


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                        scale: float):
    """The flash backward in plain PyTorch: (B, nh, N, hd) q, k, v, the
    forward's out and lse (B*nh, N), the output gradient g -> float32
    (dq, dk, dv), each (B, nh, N, hd).  q-chunked like attention_plain."""
    return attention_bwd_dyn_plain(q, g, lse, _row_dsum(g, out), k, v, scale,
                                   k.shape[2])


def _row_dsum(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in float32, (B*nh, N)."""
    b, nh, n, _ = g.shape
    return (g.float() * out.float()).sum(dim=-1).reshape(b * nh, n)


def attention_dyn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, valid_k: int):
    """:func:`attention_plain` over the first ``valid_k`` keys: q (B, nh, Nq,
    hd), k/v (B, nh, Nk, hd) -> (out (B, nh, Nq, hd), lse (B*nh, Nq)
    float32).  With no valid key the kernel's empty sums: out 0 and
    lse = -1e30 + log(1e-30), which is -1e30 in float32."""
    if valid_k == 0:
        b, nh, n, _ = q.shape
        lse = torch.full((b * nh, n), _NEG_INF, dtype=torch.float32,
                         device=q.device) + math.log(1e-30)
        return torch.zeros_like(q), lse
    return attention_plain(q, k[:, :, :valid_k], v[:, :, :valid_k], scale)


def attention_bwd_dyn_plain(q: torch.Tensor, g: torch.Tensor, lse: torch.Tensor,
                            dsum: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float, valid_k: int):
    """The dynamic-bound flash backward in plain PyTorch: q, g (B, nh, Nq,
    hd), the caller's lse and D = rowsum(dO * O), each (B*nh, Nq) float32,
    k, v (B, nh, Nk, hd) -> float32 dq (B, nh, Nq, hd) and dk, dv (B, nh,
    Nk, hd), whose rows >= ``valid_k`` are exact zeros.  q-chunked like
    attention_plain."""
    b, nh, n, hd = q.shape
    dt = q.dtype
    kf, vf = k[:, :, :valid_k].float(), v[:, :, :valid_k].float()
    lse = lse.reshape(b, nh, n, 1)
    dsum = dsum.reshape(b, nh, n, 1)
    dk = torch.zeros(b, nh, k.shape[2], hd, dtype=torch.float32,
                     device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    chunk = _plain_chunk(b, nh, max(valid_k, 1))
    for i in range(0, n, chunk):
        sl = slice(i, i + chunk)
        qc, gc = q[:, :, sl].float(), g[:, :, sl].float()
        s = torch.matmul(qc, kf.transpose(-1, -2)) * scale
        p = torch.exp(s - lse[:, :, sl])
        dv[:, :, :valid_k] += torch.matmul(p.to(dt).float().transpose(-1, -2),
                                           gc)
        dp = torch.matmul(gc, vf.transpose(-1, -2))
        ds = (p * (dp - dsum[:, :, sl]) * scale).to(dt).float()
        dk[:, :, :valid_k] += torch.matmul(ds.transpose(-1, -2), qc)
        dqs.append(torch.matmul(ds, kf))
    return torch.cat(dqs, dim=2), dk, dv


def check_flash_args(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, same_len: bool = True) -> None:
    """Raise ValueError on anything the CUDA kernel does not take.  With
    ``same_len=False`` k/v may hold another number of rows than q."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, nh, N, hd), got shape {tuple(q.shape)}")
    kv_shape = q.shape if same_len else q.shape[:2] + k.shape[2:3] + q.shape[3:]
    if k.shape != kv_shape or v.shape != kv_shape:
        raise ValueError(f"q, k, v shapes do not match: {tuple(q.shape)}, "
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
    if q.shape[2] == 0 or k.shape[2] == 0 or q.shape[0] * q.shape[1] == 0:
        raise ValueError("empty attention input")


def _check_rows(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if (t.shape != shape or t.dtype != dtype or not t.is_contiguous()
            or t.device != device):
        raise ValueError(f"{name} must be contiguous {tuple(shape)} {dtype} on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")


def _check_valid(valid_k, n_k: int) -> int:
    if not isinstance(valid_k, int) or not 0 <= valid_k <= n_k:
        raise ValueError(f"valid_k must be a host int in [0, {n_k}], got "
                         f"{valid_k!r}")
    return valid_k


def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float, return_lse: bool):
    """(out, lse or None): the forward kernel on CUDA, attention_plain on
    the CPU; any other device raises."""
    if q.device.type == "cpu":
        out, lse = attention_plain(q, k, v, scale)
        return out, (lse if return_lse else None)
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
    flash_attention.launches_f32 += q.dtype == torch.float32
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                        scale: float):
    """Float32 (dq, dk, dv) of flash attention, each (B, nh, N, hd).

    A CUDA tensor launches the backward kernel (``flash_bwd_bf16`` or, for
    float32, ``flash_bwd_f32``); a CPU tensor takes
    :func:`attention_bwd_plain`; any other device raises.  ``.launches``
    counts every launch, ``.launches_f32`` those of the float32 kernel.
    """
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, out, lse, g, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    check_flash_args(q, k, v)
    b, nh, n, hd = q.shape
    _check_rows("g", g, q.shape, q.dtype, q.device)
    _check_rows("lse", lse, (b * nh, n), torch.float32, q.device)
    dsum = _row_dsum(g, out)
    dq, dk, dv = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
                  for _ in range(3))
    lib = _build.library()
    rc = lib.dtt_flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b * nh, n, hd, int(q.dtype == torch.bfloat16),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("flash_attn_bwd", rc)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_f32 += q.dtype == torch.float32
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_f32 = 0


def flash_attention_with_lse_dyn(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, scale: float, valid_k: int):
    """Flash attention of q (B, nh, Nq, hd) over the first ``valid_k`` rows
    of k/v (B, nh, Nk, hd) -> (out (B, nh, Nq, hd), lse (B*nh, Nq)
    float32); the LSE is always returned.  One ring-attention hop.

    A CUDA tensor launches the dynamic-bound forward kernel; a CPU tensor
    takes :func:`attention_dyn_plain`; any other device raises.
    """
    valid_k = _check_valid(valid_k, k.shape[2])
    if q.device.type == "cpu":
        return attention_dyn_plain(q, k, v, scale, valid_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_with_lse_dyn: unsupported device "
                         f"{q.device}")
    check_flash_args(q, k, v, same_len=False)
    b, nh, n, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * nh, n), dtype=torch.float32, device=q.device)
    lib = _build.library()
    rc = lib.dtt_flash_attn_fwd_dyn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b * nh, n, k.shape[2], valid_k, hd,
        int(q.dtype == torch.bfloat16), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("flash_attn_fwd_dyn", rc)
    flash_attention_with_lse_dyn.launches += 1
    return out, lse


flash_attention_with_lse_dyn.launches = 0


def flash_attention_bwd_dyn(q: torch.Tensor, g: torch.Tensor,
                            lse: torch.Tensor, dsum: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor, scale: float,
                            valid_k: int):
    """Float32 (dq, dk, dv) of one ring-attention hop: q, g (B, nh, Nq, hd),
    the GLOBAL lse and D = rowsum(dO * O) (B*nh, Nq) float32 from the
    caller, k, v (B, nh, Nk, hd); keys >= ``valid_k`` are dead and their dk,
    dv rows are exact zeros.

    A CUDA tensor launches the dynamic-bound backward kernel; a CPU tensor
    takes :func:`attention_bwd_dyn_plain`; any other device raises.
    ``.launches`` counts every launch, ``.launches_f32`` those of the
    float32 kernel.
    """
    valid_k = _check_valid(valid_k, k.shape[2])
    if q.device.type == "cpu":
        return attention_bwd_dyn_plain(q, g, lse, dsum, k, v, scale, valid_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_dyn: unsupported device "
                         f"{q.device}")
    check_flash_args(q, k, v, same_len=False)
    b, nh, n, hd = q.shape
    _check_rows("g", g, q.shape, q.dtype, q.device)
    _check_rows("lse", lse, (b * nh, n), torch.float32, q.device)
    _check_rows("dsum", dsum, (b * nh, n), torch.float32, q.device)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = (torch.empty(k.shape, dtype=torch.float32, device=q.device)
              for _ in range(2))
    lib = _build.library()
    rc = lib.dtt_flash_attn_bwd_dyn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b * nh, n, k.shape[2], valid_k, hd,
        int(q.dtype == torch.bfloat16), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("flash_attn_bwd_dyn", rc)
    flash_attention_bwd_dyn.launches += 1
    flash_attention_bwd_dyn.launches_f32 += q.dtype == torch.float32
    return dq, dk, dv


flash_attention_bwd_dyn.launches = 0
flash_attention_bwd_dyn.launches_f32 = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention with the flash backward: the forward keeps the row
    lse, the backward runs :func:`flash_attention_bwd` (the counterpart of
    the JAX package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _flash_fwd(q, k, v, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, g.to(q.dtype).contiguous(), ctx.scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, return_lse: bool = False):
    """Flash attention over (B, nh, N, hd) -> (B, nh, N, hd).

    With ``return_lse`` also returns the row log-sum-exp, (B*nh, N) float32.
    A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`attention_plain`; any other device raises.  When autograd needs a
    gradient of q, k or v, the call goes through :class:`FlashAttention`,
    whose backward is the flash backward on both devices.  ``.launches``
    counts every launch, ``.launches_f32`` those of the float32 kernel
    (``flash_fwd_f32``).
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = FlashAttention.apply(q, k, v, scale)
    else:
        out, lse = _flash_fwd(q, k, v, scale, return_lse)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.launches_f32 = 0


def attention_probs(q: torch.Tensor, k: torch.Tensor, scale: float,
                    cls_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax probabilities (B, nh, Nq, N), float32: the counterpart of
    ``dino_tpu``'s ``attention_probs_xla``, a plain matmul and softmax (no
    kernel: the JAX package runs XLA here, not Pallas).

    With ``cls_mask`` (n_masks, gh, gw), binary: q is cut to the CLS query
    of the first image BEFORE the product, the flattened masks get a zero
    column prepended for the CLS key and MULTIPLY the logits (no -inf), so
    the result is (1, nh, n_masks, N) and no (N, N) matrix is formed.
    """
    if cls_mask is not None:
        q = q[0:1, :, 0:1, :]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if cls_mask is not None:
        n_masks = cls_mask.shape[0]
        flat = cls_mask.reshape(n_masks, -1).to(torch.float32)
        flat = torch.cat([flat.new_zeros(n_masks, 1), flat], dim=1)
        logits = logits * flat.to(logits.device)
    return torch.softmax(logits, dim=-1)


def attention_with_probs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, cls_mask: Optional[torch.Tensor] = None,
                         attn_drop=None):
    """(out, probs): :func:`attention_probs`, then P.V with P cast to v's
    dtype and the product summed in float32, out in v's dtype (``dino_tpu``'s
    ``attention_xla``).  ``attn_drop``, a (rate, torch.Generator) pair, drops
    probabilities (inverted dropout) before P.V; the returned probs are the
    undropped ones."""
    probs = attention_probs(q, k, scale, cls_mask)
    applied = probs
    if attn_drop is not None:
        rate, generator = attn_drop
        keep = 1.0 - rate
        mask = torch.rand(probs.shape, generator=generator,
                          device=generator.device).to(probs.device) < keep
        applied = torch.where(mask, probs / keep, 0.0)
    out = torch.matmul(applied.to(v.dtype).float(), v.float()).to(v.dtype)
    return out, probs


def _project(lin, x: torch.Tensor) -> torch.Tensor:
    if isinstance(lin, QuantLinear):
        return int8_dense(lin, x)
    return dense(x, lin.weight, lin.bias)


def multi_head_attention(attn, x: torch.Tensor, *, num_heads: int,
                         scale: float, cls_mask: Optional[torch.Tensor] = None,
                         need_probs: bool = False, attn_drop=None):
    """MHSA: qkv projection -> attention -> out projection; returns (out,
    probs or None).

    ``attn`` holds ``qkv`` and ``proj`` (nn.Linear, reference names):
    :func:`~dino_tpu_torch.models.heads.dense` layers, or int8 products
    where they hold int8 codes (``ops.quant.QuantLinear``), as
    ``dino_tpu``'s ``dense`` takes ``int8_dense`` for a layer with
    ``kernel_i8``.  q, k, v come out
    head-major, (B, nh, N, hd) each and contiguous.  Unless probabilities
    are asked for (``need_probs``), a ``cls_mask`` is given or ``attn_drop``
    (rate, generator) drops them, the attention is :func:`flash_attention`;
    otherwise :func:`attention_with_probs`, and with a ``cls_mask`` the
    output holds one token per mask, (1, n_masks, C).
    """
    b, n, c = x.shape
    hd = c // num_heads
    qkv = _project(attn.qkv, x)
    qkv = qkv.reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    qkv = qkv.contiguous()
    probs = None
    if need_probs or cls_mask is not None or attn_drop is not None:
        out, probs = attention_with_probs(qkv[0], qkv[1], qkv[2], scale,
                                          cls_mask, attn_drop)
    else:
        out = flash_attention(qkv[0], qkv[1], qkv[2], scale)
    out = out.permute(0, 2, 1, 3).reshape(out.shape[0], out.shape[2], c)
    return _project(attn.proj, out), probs
