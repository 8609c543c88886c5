"""int8 serving quantization: the counterpart of ``dino_tpu/ops/quant.py``.

Weights quantize per output channel once, when the serving copy is built;
activations quantize per token (dynamic row max) inside the forward, so the
fat projections (qkv, attention out, MLP fc1/fc2) run as an int8 x int8 ->
int32 product, dequantized with two rank-1 scale vectors.  The patch embed,
CLS/pos-embed, LayerNorms, softmax, attention and the head stay float.

The product is ``torch._int_mm`` on both devices (cuBLASLt's int8 GEMM on the
card; exact integer sums on the CPU).  ``dino_tpu``'s int8 product is an XLA
dot, not a Pallas kernel.  ``_int_mm`` takes A (M, K) row-major and B (K, N)
column-major on the card, with M > 16 and K, N multiples of 8: the codes are
stored (out, in) contiguous, as ``nn.Linear`` stores its weight, and passed
transposed, which is B in that layout without a copy; fewer than 17 rows are
padded.

Roundings, as ``dino_tpu`` computes them (its weights quantize eagerly, its
activations inside the jitted predict), the same on the card and the CPU:

  * weight scale ``max(|w|, 1e-12) / 127`` and codes ``round(w / s)``, true
    divisions (eager JAX).  The divisor 127 is a tensor: PyTorch's CUDA
    ``div`` by a Python scalar multiplies by its reciprocal;
  * token scale ``max(|x|, 1e-12) * fl(1/127)``: XLA rewrites the division
    by the constant 127 into a product with its reciprocal;
  * token codes ``round(x / s_row)``, a true division (the divisor is data);
  * ``y * s_row * s_col + b`` as ``fma(y * s_row, s_col, b)``: XLA:CPU fuses
    the last product and the bias add.  PyTorch has no fma that holds on
    both devices (CUDA's ``addcmul`` rounds the product first), so the
    product and the sum run in float64, where the product of two float32
    values is exact, and round to float32: the fma's result but where the
    float64 sum lands exactly half-way between two float32 values (double
    rounding; none in tests/test_torch_port_quant.py's outputs).  Then one rounding to the input
    dtype.

``torch.round`` and ``jnp.round`` both round half to even.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn as nn

_EPS = 1e-12
_MIN_ROWS = 17  # _int_mm on the card wants more than 16 rows
# fl(1/127): the token scale's factor after XLA's rewrite of "/ 127.0"; a
# Python float holding a float32 value exactly, so no tensor crosses to the
# card per call (a CUDA graph could not capture that copy)
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


class QuantLinear(nn.Module):
    """A dense layer in int8 serving form: ``weight_i8`` (out, in) int8
    codes, ``w_scale`` (out,) float32 per-channel scales and the float32
    ``bias``.  Buffers, not parameters: the serving copy does not train."""

    def __init__(self, weight_i8: torch.Tensor, w_scale: torch.Tensor,
                 bias: torch.Tensor):
        super().__init__()
        self.register_buffer("weight_i8", weight_i8)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("bias", bias)

    @property
    def out_features(self) -> int:
        return self.weight_i8.shape[0]


@torch.no_grad()
def quantize_dense(weight: torch.Tensor, bias: torch.Tensor) -> QuantLinear:
    """float ``weight`` (out, in) and ``bias`` -> :class:`QuantLinear`,
    per output channel: s = max(|w|, 1e-12) / 127, codes round(w / s)
    clipped to +-127."""
    w = weight.detach().float()
    amax = w.abs().amax(dim=1).clamp_min(_EPS)
    s = amax / torch.full_like(amax, 127.0)
    codes = torch.clamp(torch.round(w / s[:, None]), -127, 127)
    return QuantLinear(codes.to(torch.int8).contiguous(), s,
                       bias.detach().float().clone())


def quantize_tokens(x: torch.Tensor):
    """(..., K) float -> (int8 codes (..., K), float32 scales (..., 1)): the
    dynamic per-token scale and codes of :func:`int8_dense`."""
    xf = x.float()
    s_row = xf.abs().amax(dim=-1, keepdim=True).clamp_min(_EPS) * _INV_127
    codes = torch.clamp(torch.round(xf / s_row), -127, 127)
    return codes.to(torch.int8), s_row


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) int32 by ``torch._int_mm``,
    padding M past 16 rows."""
    m = a.shape[0]
    if m < _MIN_ROWS:
        a = torch.cat([a, a.new_zeros(_MIN_ROWS - m, a.shape[1])])
    return torch._int_mm(a, b_t.t())[:m]


def int8_dense(q: QuantLinear, x: torch.Tensor) -> torch.Tensor:
    """y = (x_i8 @ W_i8) * s_row * s_col + b in float32, rounded once to
    ``x.dtype``; x (..., in) -> (..., out)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_dense: unsupported device {x.device}")
    x2 = x.reshape(-1, x.shape[-1])
    codes, s_row = quantize_tokens(x2)
    # int32 -> float32 (rounded, as XLA's convert) times s_row, one pass
    y = int_mm(codes, q.weight_i8) * s_row
    # y promoted to float64 inside the kernel; the cast back rounds to
    # float32, then to x's dtype, in one pass
    out = torch.addcmul(q.bias.double(), y, q.w_scale.double())
    return out.to(x.dtype).reshape(*x.shape[:-1], q.out_features)


def quantize_vit(vit: nn.Module) -> nn.Module:
    """A serving copy of a ViT whose blocks' qkv, proj, fc1 and fc2 are
    :class:`QuantLinear`; the patch embed, CLS/pos-embed and every
    LayerNorm are the same tensors as ``vit``'s (shared, not copied)."""
    memo = {id(t): t for t in list(vit.parameters()) + list(vit.buffers())}
    out = copy.deepcopy(vit, memo)
    for blk in out.blocks:
        for parent, name in ((blk.attn, "qkv"), (blk.attn, "proj"),
                             (blk.mlp, "fc1"), (blk.mlp, "fc2")):
            lin = getattr(parent, name)
            setattr(parent, name, quantize_dense(lin.weight, lin.bias))
    return out
