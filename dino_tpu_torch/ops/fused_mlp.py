"""Fused LayerNorm + MLP + residual: the second half of a ViT block.

``fused_ln_mlp_residual`` is the port of ``dino_tpu/ops/fused_mlp.py``'s
Pallas kernel.  On a CUDA bf16 tensor it launches ``csrc/fused_ln_mlp.cu``,
which keeps the (rows, hidden) activation out of device memory; on a CPU
tensor it runs ``fused_ln_mlp_residual_plain``, the same arithmetic in plain
PyTorch.  Like the JAX package, the model takes it only on the bf16 path
when no gradient is needed; under autograd, and in float32, it runs the
composition with true erf (``models/vit.py:mlp_residual``), as the JAX
``custom_vjp`` forward rule runs ``_xla_reference``.  The kernel has no
backward, so the wrapper raises rather than return an output that autograd
cannot see through.

Per row: LN with float32 statistics (eps from the caller) -> cast to the
input dtype -> fc1 + b1 (f32 accumulation) -> GELU with the Abramowitz &
Stegun 7.1.26 erf in float32 -> cast -> fc2 + b2 (f32 accumulation) -> cast
-> residual add in the input dtype.
"""
from __future__ import annotations

import torch

from dino_tpu_torch.ops import _build

_EMBED_DIM = 384
_HIDDEN_STEP = 64


def erf_as(z: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26 rational erf approximation (|err| < 1.5e-7)."""
    sign = torch.sign(z)
    az = torch.abs(z)
    t = 1.0 / (1.0 + 0.3275911 * az)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429))))
    return sign * (1.0 - poly * torch.exp(-az * az))


def fused_ln_mlp_residual_plain(norm, mlp, x: torch.Tensor,
                                eps: float) -> torch.Tensor:
    """x: (..., D) -> x + fc2(gelu_as(fc1(LN(x)))), kernel numerics.

    ``norm`` is an nn.LayerNorm, ``mlp`` holds ``fc1``/``fc2`` nn.Linear
    (weights (out, in)).  Products take input-dtype operands and accumulate
    in float32 (computed in float32 on operands rounded to the input dtype).
    """
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    h = ((xf - mu) * torch.rsqrt(var + eps) * norm.weight.float()
         + norm.bias.float()).to(dt)
    h = (torch.matmul(h.float(), mlp.fc1.weight.to(dt).float().t())
         + mlp.fc1.bias.float())
    z = h * 0.7071067811865476
    h = (h * 0.5 * (1.0 + erf_as(z))).to(dt)
    h = (torch.matmul(h.float(), mlp.fc2.weight.to(dt).float().t())
         + mlp.fc2.bias.float())
    return x + h.to(dt)


def check_mlp_args(norm, mlp, x: torch.Tensor) -> None:
    """Raise ValueError on anything the CUDA kernel does not take."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused MLP kernel takes bf16 activations, got "
                         f"{x.dtype}")
    if x.shape[-1] != _EMBED_DIM:
        raise ValueError(f"fused MLP kernel takes D={_EMBED_DIM}, got "
                         f"{x.shape[-1]}")
    hidden, d_in = mlp.fc1.weight.shape
    if d_in != _EMBED_DIM or hidden <= 0 or hidden % _HIDDEN_STEP:
        raise ValueError(f"fused MLP kernel takes fc1 (H, {_EMBED_DIM}) with "
                         f"H a multiple of {_HIDDEN_STEP}, got "
                         f"{tuple(mlp.fc1.weight.shape)}")
    if tuple(mlp.fc2.weight.shape) != (_EMBED_DIM, hidden):
        raise ValueError(f"fc2 weight must be ({_EMBED_DIM}, {hidden}), got "
                         f"{tuple(mlp.fc2.weight.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for t in (mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias,
              norm.weight, norm.bias):
        if t.device != x.device:
            raise ValueError("weights and x must be on one device")


def fused_ln_mlp_residual(norm, mlp, x: torch.Tensor,
                          eps: float) -> torch.Tensor:
    """x: (..., 384) bf16 -> x + fc2(gelu(fc1(LN(x)))) in one kernel.

    A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`fused_ln_mlp_residual_plain`; any other device raises, and so
    does a call that autograd would have to differentiate.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_ln_mlp_residual: unsupported device "
                         f"{x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *norm.parameters(),
                                      *mlp.parameters())):
        raise RuntimeError("fused_ln_mlp_residual has no backward: call it "
                           "under torch.no_grad() or on tensors that do not "
                           "require grad (models/vit.py:block_apply runs "
                           "mlp_residual under autograd)")
    if x.device.type == "cpu":
        return fused_ln_mlp_residual_plain(norm, mlp, x, eps)
    check_mlp_args(norm, mlp, x)
    d = x.shape[-1]
    hidden = mlp.fc1.weight.shape[0]
    m = x.numel() // d
    bf16, f32 = torch.bfloat16, torch.float32
    w1 = mlp.fc1.weight.to(bf16).contiguous()
    w2 = mlp.fc2.weight.to(bf16).contiguous()
    b1 = mlp.fc1.bias.to(f32).contiguous()
    b2 = mlp.fc2.bias.to(f32).contiguous()
    g = norm.weight.to(f32).contiguous()
    beta = norm.bias.to(f32).contiguous()
    out = torch.empty_like(x)
    if m == 0:
        return out
    lib = _build.library()
    rc = lib.dtt_fused_ln_mlp(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), g.data_ptr(), beta.data_ptr(), out.data_ptr(),
        m, d, hidden, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch("fused_ln_mlp", rc)
    fused_ln_mlp_residual.launches += 1
    return out


fused_ln_mlp_residual.launches = 0
