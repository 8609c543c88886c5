"""DINO Vision Transformer in PyTorch (inference and training).

Modules hold the parameters under the reference's torch names
(``patch_embed.proj.weight`` (D, 3, P, P), ``blocks.{i}.attn.qkv.weight``
(out, in), ``norm1.weight``, ...), so a reference state_dict loads with
``strict=True``.  The forward is written as plain functions over those
modules, one per function of ``dino_tpu/models/vit.py``:

  * images are (B, H, W, 3), as in the JAX package;
  * patchify is a reshape + matmul against the flattened conv weight, not a
    convolution;
  * pos-embed resampling is two matmuls against torch-exact bicubic weights,
    with the reference's +0.1 anti-round-off hack;
  * attention runs the flash kernels on CUDA tensors (forward, and under
    autograd the flash backward); the bf16 path on CUDA with no gradient
    runs the fused LN+MLP+residual kernel, and under autograd or in float32
    the MLP is a composition with true erf;
  * ``vit_forward(..., remat=True)`` recomputes each block in the backward
    pass (``torch.utils.checkpoint``), trading FLOPs for activation memory.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from dino_tpu_torch.models.heads import affine, dense
from dino_tpu_torch.ops.attention import multi_head_attention
from dino_tpu_torch.ops.bicubic import bicubic_resize_matrix
from dino_tpu_torch.ops.fused_mlp import fused_ln_mlp_residual


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 8
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    ln_eps: float = 1e-6
    img_size: int = 224

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def scale(self) -> float:
        return self.qk_scale if self.qk_scale is not None else self.head_dim ** -0.5

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def mlp_hidden(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)


def vit_tiny(patch_size: int = 16, **kw) -> ViTConfig:
    return ViTConfig(patch_size=patch_size, embed_dim=192, depth=12, num_heads=3, **kw)


def vit_small(patch_size: int = 16, **kw) -> ViTConfig:
    return ViTConfig(patch_size=patch_size, embed_dim=384, depth=12, num_heads=6, **kw)


def vit_base(patch_size: int = 16, **kw) -> ViTConfig:
    return ViTConfig(patch_size=patch_size, embed_dim=768, depth=12, num_heads=12, **kw)


# ---------------------------------------------------------------------------
# Modules (parameter holders with the reference's names)
# ---------------------------------------------------------------------------

class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size,
                              stride=cfg.patch_size)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.qkv = nn.Linear(cfg.embed_dim, 3 * cfg.embed_dim,
                             bias=cfg.qkv_bias)
        self.proj = nn.Linear(cfg.embed_dim, cfg.embed_dim)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.embed_dim, cfg.mlp_hidden)
        self.fc2 = nn.Linear(cfg.mlp_hidden, cfg.embed_dim)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.attn = Attention(cfg)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.mlp = Mlp(cfg)


class VisionTransformer(nn.Module):
    """Parameters of a (possibly truncated) DINO ViT; ``forward`` is
    :func:`vit_forward`."""

    def __init__(self, cfg: ViTConfig, depth: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        depth = cfg.depth if depth is None else depth
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.num_patches + 1, cfg.embed_dim))
        self.patch_embed = PatchEmbed(cfg)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(depth))
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)

    def forward(self, x: torch.Tensor, intermediate: int = 0) -> torch.Tensor:
        return vit_forward(self, x, self.cfg, intermediate=intermediate)


@torch.no_grad()
def init_vit_params(model: VisionTransformer,
                    generator: torch.Generator) -> VisionTransformer:
    """Random init matching the reference's distributions: trunc_normal
    (std .02, cut at 2 std) for linear weights, CLS and pos-embed; zero
    biases; torch Conv2d default U(-1/sqrt(fan_in), ..) for the patch embed;
    LayerNorm ones/zeros.  Draws from ``generator`` on the CPU."""
    def tn(t):
        nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04,
                              generator=generator)

    tn(model.cls_token)
    tn(model.pos_embed)
    proj = model.patch_embed.proj
    bound = 1.0 / math.sqrt(proj.weight[0].numel())
    nn.init.uniform_(proj.weight, -bound, bound, generator=generator)
    nn.init.uniform_(proj.bias, -bound, bound, generator=generator)
    for blk in model.blocks:
        for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
            tn(lin.weight)
            nn.init.zeros_(lin.bias)
        for ln in (blk.norm1, blk.norm2):
            nn.init.ones_(ln.weight)
            nn.init.zeros_(ln.bias)
    nn.init.ones_(model.norm.weight)
    nn.init.zeros_(model.norm.bias)
    return model


# ---------------------------------------------------------------------------
# Forward building blocks
# ---------------------------------------------------------------------------

def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with float32 statistics, output in the input dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], ln.weight.float(),
                     ln.bias.float(), eps)
    return y.to(x.dtype)


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, C*P*P) with per-patch (c, ph, pw) element order,
    the order of a flattened Conv2d weight (D, C, P, P)."""
    b, h, w, c = x.shape
    p = patch_size
    gh, gw = h // p, w // p
    x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, gh * gw, c * p * p)


@functools.lru_cache(maxsize=None)
def _pos_interp_mats(grid_in: int, rows_out: int, cols_out: int):
    """Torch-exact bicubic weight matrices for pos-embed resampling, with the
    reference's axis pairing and +0.1 hack in both the scale and (through
    floor) the output size."""
    wr = bicubic_resize_matrix(grid_in, (rows_out + 0.1) / grid_in)
    wc = bicubic_resize_matrix(grid_in, (cols_out + 0.1) / grid_in)
    assert wr.shape[0] == rows_out and wc.shape[0] == cols_out
    return wr, wc


def interpolate_pos_encoding(pos_embed: torch.Tensor, h: int, w: int,
                             patch_size: int) -> torch.Tensor:
    """Resample (1, N+1, D) pos-embed to an image of (h, w) pixels."""
    n = pos_embed.shape[1] - 1
    gh, gw = h // patch_size, w // patch_size
    if gh * gw == n and h == w:
        return pos_embed
    grid_in = int(math.isqrt(n))
    cls_pos = pos_embed[:, :1]
    patch_pos = pos_embed[0, 1:].reshape(grid_in, grid_in, -1).float()
    wr, wc = (torch.from_numpy(m).to(pos_embed.device)
              for m in _pos_interp_mats(grid_in, gh, gw))
    out = torch.einsum("rg,ghd->rhd", wr, patch_pos)
    out = torch.einsum("ch,rhd->rcd", wc, out)
    out = out.reshape(1, gh * gw, -1).to(pos_embed.dtype)
    return torch.cat([cls_pos, out], dim=1)


def prepare_tokens(model: VisionTransformer, x: torch.Tensor,
                   cfg: ViTConfig) -> torch.Tensor:
    """(B, H, W, 3) image -> (B, 1+N, D) tokens (patchify + CLS + pos-embed)."""
    if not x.dtype.is_floating_point:
        # the network runs in the input dtype; an integer image would drag
        # every matmul to an integer type.  Raw frames go through
        # ops.preprocess first.
        raise TypeError(
            f"prepare_tokens expects float (ImageNet-normalized) pixels, "
            f"got {x.dtype}; route raw uint8 frames through "
            f"dino_tpu_torch.ops.preprocess")
    b, h, w, _ = x.shape
    proj = model.patch_embed.proj
    patches = dense(patchify(x, cfg.patch_size),
                    proj.weight.reshape(proj.weight.shape[0], -1), proj.bias)
    cls = model.cls_token.to(x.dtype).expand(b, 1, cfg.embed_dim)
    tokens = torch.cat([cls, patches], dim=1)
    pos = interpolate_pos_encoding(model.pos_embed, h, w, cfg.patch_size)
    return tokens + pos.to(tokens.dtype)


def mlp_residual(norm: nn.LayerNorm, mlp: Mlp, x: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """x + fc2(gelu(fc1(LN(x)))) as a differentiable composition with the
    numerics of ``dino_tpu/ops/fused_mlp.py:_xla_reference``: LN in float32
    -> cast -> fc1 + f32 bias -> true-erf GELU in float32 -> cast -> fc2 +
    f32 bias -> cast -> residual add in the input dtype.  Each product is
    accumulated in float32 and takes its bias unrounded (:func:`affine`)."""
    dt = x.dtype
    h = layer_norm(norm, x, eps)
    h = F.gelu(affine(mlp.fc1, h), approximate="none").to(dt)
    return x + affine(mlp.fc2, h, dt)


def _needs_grad(blk: Block, x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in blk.parameters()))


def block_apply(blk: Block, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """One pre-LN transformer block.

    The fused MLP kernel runs only on the bf16 CUDA path when no gradient
    is needed (the kernel has no backward); otherwise the MLP is the
    differentiable composition :func:`mlp_residual`.
    """
    x = x + multi_head_attention(blk.attn, layer_norm(blk.norm1, x, cfg.ln_eps),
                                 num_heads=cfg.num_heads, scale=cfg.scale)
    if (x.is_cuda and x.dtype == torch.bfloat16
            and not _needs_grad(blk, x)):
        return fused_ln_mlp_residual(blk.norm2, blk.mlp, x, cfg.ln_eps)
    return mlp_residual(blk.norm2, blk.mlp, x, cfg.ln_eps)


def vit_forward(model: VisionTransformer, x: torch.Tensor, cfg: ViTConfig, *,
                all_tokens: bool = True, intermediate: int = 0,
                remat: bool = False) -> torch.Tensor:
    """Forward through all (possibly truncated) blocks + final LayerNorm.

    ``intermediate=i`` returns ``norm(x)`` right after block i (1-indexed),
    as the reference's ``forward(intermediate=i)``.  ``remat=True``
    recomputes each block's activations in the backward pass instead of
    storing them.
    """
    tokens = prepare_tokens(model, x, cfg)
    for i, blk in enumerate(model.blocks):
        if remat:
            tokens = torch.utils.checkpoint.checkpoint(
                block_apply, blk, tokens, cfg, use_reentrant=False)
        else:
            tokens = block_apply(blk, tokens, cfg)
        if intermediate and i == intermediate - 1:
            return layer_norm(model.norm, tokens, cfg.ln_eps)
    tokens = layer_norm(model.norm, tokens, cfg.ln_eps)
    return tokens if all_tokens else tokens[:, 0]


def truncate_blocks(model: VisionTransformer,
                    n_blocks: int) -> VisionTransformer:
    """Keep only the first n blocks (reference ``dino.blocks = blocks[:n]``)."""
    model.blocks = nn.ModuleList(list(model.blocks)[:n_blocks])
    return model
