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
  * a model whose blocks hold int8 codes (``ops/quant.py:quantize_vit``)
    runs qkv, proj, fc1 and fc2 as int8 products, and its MLP as LN -> int8
    fc1 -> true-erf GELU -> int8 fc2 -> residual, never the fused kernel,
    as ``dino_tpu`` does;
  * ``vit_forward(..., remat=True)`` recomputes each block in the backward
    pass (``torch.utils.checkpoint``), trading FLOPs for activation memory;
  * ``get_last_selfattention`` (full, masked or CLS-row only),
    ``forward_mask`` and ``get_intermediate_layers`` run the earlier blocks
    as ``vit_forward`` does and the last block's attention through its
    materialized probabilities (``ops.attention.attention_probs``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from dino_tpu_torch.models.heads import affine, dense
from dino_tpu_torch.ops.attention import (attention_probs,
                                          multi_head_attention)
from dino_tpu_torch.ops.bicubic import bicubic_resize_matrix
from dino_tpu_torch.ops.fused_mlp import fused_ln_mlp_residual
from dino_tpu_torch.ops.quant import QuantLinear, int8_dense


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
    # Train-mode regularization, 0 in every reference config.  block_apply
    # reads drop_rate and attn_drop_rate, and takes each block's drop-path
    # rate as an argument; vit_forward passes no generator, so none of the
    # three acts until a train loop draws them (the fit path, ROADMAP
    # item 5).  drop_path_rate is kept for that loop, as dino_tpu keeps it.
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0

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


# _pos_interp_mats per (grid_in, rows_out, cols_out, device), copied to the
# device once (as ops/resize.py's taps): no host-to-device copy per call,
# which a CUDA graph could not capture
_DEVICE_POS_MATS: Dict[Tuple[int, int, int, torch.device],
                       Tuple[torch.Tensor, torch.Tensor]] = {}


def _device_pos_interp_mats(grid_in: int, rows_out: int, cols_out: int,
                            device: torch.device):
    key = (grid_in, rows_out, cols_out, device)
    if key not in _DEVICE_POS_MATS:
        _DEVICE_POS_MATS[key] = tuple(
            torch.from_numpy(m).to(device)
            for m in _pos_interp_mats(grid_in, rows_out, cols_out))
    return _DEVICE_POS_MATS[key]


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
    wr, wc = _device_pos_interp_mats(grid_in, gh, gw, pos_embed.device)
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


def drop_path(x: torch.Tensor, rate: float,
              generator: torch.Generator) -> torch.Tensor:
    """Stochastic depth: zero the residual branch per sample with
    probability ``rate`` and scale the kept ones by 1/(1 - rate): mask =
    floor(keep + U[0, 1)) per sample, drawn from ``generator``."""
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    u = torch.rand(shape, generator=generator, device=generator.device)
    mask = torch.floor(keep + u).to(x.device)
    return (x / keep) * mask.to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 - rate and
    scaled by 1/(1 - rate), the mask drawn from ``generator``."""
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    return torch.where(u.to(x.device) < keep, x / keep, 0.0).to(x.dtype)


def mlp_residual(norm: nn.LayerNorm, mlp: Mlp, x: torch.Tensor, eps: float,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x + fc2(gelu(fc1(LN(x)))) as a differentiable composition with the
    numerics of ``dino_tpu/ops/fused_mlp.py:_xla_reference``: LN in float32
    -> cast -> fc1 + f32 bias -> true-erf GELU in float32 -> cast -> fc2 +
    f32 bias -> cast -> residual add in the input dtype.  Each product is
    accumulated in float32 and takes its bias unrounded (:func:`affine`).
    With a ``generator``, train-mode dropout after the GELU and after fc2,
    then drop-path on the branch, each where its rate is > 0."""
    dt = x.dtype
    h = layer_norm(norm, x, eps)
    h = F.gelu(affine(mlp.fc1, h), approximate="none").to(dt)
    drop = generator is not None and drop_rate > 0
    if drop:
        h = dropout(h, drop_rate, generator)
    h = affine(mlp.fc2, h, dt)
    if drop:
        h = dropout(h, drop_rate, generator)
    if generator is not None and drop_path_rate > 0:
        h = drop_path(h, drop_path_rate, generator)
    return x + h


def mlp_residual_int8(norm: nn.LayerNorm, mlp: Mlp, x: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """x + fc2(gelu(fc1(LN(x)))) over int8 fc1/fc2, at ``dino_tpu``'s
    rounding points: each int8 product rounds to x's dtype, the GELU (true
    erf, in float32) rounds once more, and the residual adds in x's
    dtype."""
    h = int8_dense(mlp.fc1, layer_norm(norm, x, eps))
    h = F.gelu(h.float(), approximate="none").to(x.dtype)
    return x + int8_dense(mlp.fc2, h)


def _needs_grad(blk: Block, x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in blk.parameters()))


def block_apply(blk: Block, x: torch.Tensor, cfg: ViTConfig,
                cls_mask: Optional[torch.Tensor] = None,
                need_probs: bool = False, drop_path_rate: float = 0.0,
                generator: Optional[torch.Generator] = None):
    """One pre-LN transformer block; returns (x_out, probs or None).

    ``need_probs`` or a ``cls_mask`` (n_masks, gh, gw) take attention
    through the materialized probabilities; with a mask the block's output
    is one token per mask, (1, n_masks, D), over the CLS residual repeated
    per mask.  Train-mode regularization (``cfg.drop_rate``,
    ``cfg.attn_drop_rate``, ``drop_path_rate``; 0 in every reference
    config) engages only when a ``generator`` is passed and a rate is > 0.

    The fused MLP kernel runs only on the bf16 CUDA path when no gradient
    is needed and no regularization is on (the kernel has no backward);
    otherwise the MLP is the differentiable composition
    :func:`mlp_residual`.  A block in int8 serving form runs
    :func:`mlp_residual_int8`.
    """
    train = generator is not None and (cfg.drop_rate > 0
                                       or cfg.attn_drop_rate > 0
                                       or drop_path_rate > 0)
    gen = generator if train else None
    y, probs = multi_head_attention(
        blk.attn, layer_norm(blk.norm1, x, cfg.ln_eps),
        num_heads=cfg.num_heads, scale=cfg.scale, cls_mask=cls_mask,
        need_probs=need_probs,
        attn_drop=(cfg.attn_drop_rate, gen) if train
        and cfg.attn_drop_rate > 0 else None)
    if train and cfg.drop_rate > 0:
        y = dropout(y, cfg.drop_rate, gen)  # proj_drop
    if cls_mask is not None:
        # the CLS residual, once per mask
        x = x[:, :1, :].expand(x.shape[0], cls_mask.shape[0], x.shape[-1])
    if train and drop_path_rate > 0:
        y = drop_path(y, drop_path_rate, gen)
    x = x + y
    if isinstance(blk.mlp.fc1, QuantLinear):
        return mlp_residual_int8(blk.norm2, blk.mlp, x, cfg.ln_eps), probs
    if (not train and x.is_cuda and x.dtype == torch.bfloat16
            and not _needs_grad(blk, x)):
        return fused_ln_mlp_residual(blk.norm2, blk.mlp, x, cfg.ln_eps), probs
    return mlp_residual(blk.norm2, blk.mlp, x, cfg.ln_eps, cfg.drop_rate,
                        drop_path_rate, gen), probs


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
                block_apply, blk, tokens, cfg, use_reentrant=False)[0]
        else:
            tokens = block_apply(blk, tokens, cfg)[0]
        if intermediate and i == intermediate - 1:
            return layer_norm(model.norm, tokens, cfg.ln_eps)
    tokens = layer_norm(model.norm, tokens, cfg.ln_eps)
    return tokens if all_tokens else tokens[:, 0]


def _tokens_before_last(model: VisionTransformer, x: torch.Tensor,
                        cfg: ViTConfig) -> torch.Tensor:
    tokens = prepare_tokens(model, x, cfg)
    for blk in list(model.blocks)[:-1]:
        tokens = block_apply(blk, tokens, cfg)[0]
    return tokens


def get_last_selfattention(model: VisionTransformer, x: torch.Tensor,
                           cfg: ViTConfig,
                           cls_mask: Optional[torch.Tensor] = None,
                           cls_only: bool = False) -> torch.Tensor:
    """Attention probabilities of the last block, float32.

    By default the full (B, nh, N, N) matrix, as the reference returns it;
    with a ``cls_mask`` (n_masks, gh, gw) the masked CLS rows, (1, nh,
    n_masks, N).  ``cls_only=True`` projects q for the CLS token alone and
    returns (B, nh, 1, N) (or the masked rows): O(N) memory, which makes
    960px maps (N = 14,401; the full matrix is ~5 GB) cheap.
    """
    tokens = _tokens_before_last(model, x, cfg)
    last = model.blocks[-1]
    if not cls_only:
        return block_apply(last, tokens, cfg, cls_mask=cls_mask,
                           need_probs=True)[1]
    h = layer_norm(last.norm1, tokens, cfg.ln_eps)
    b, n, c = h.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    # the (3C, C) weight's rows are (3, nh, hd): the q and k thirds
    w = last.attn.qkv.weight.reshape(3, c, c)
    bias = last.attn.qkv.bias.reshape(3, c)
    q_cls = dense(h[:, :1, :], w[0], bias[0])  # q of the CLS token only
    q_cls = q_cls.reshape(b, 1, nh, hd).permute(0, 2, 1, 3)
    k = dense(h, w[1], bias[1]).reshape(b, n, nh, hd).permute(0, 2, 1, 3)
    return attention_probs(q_cls, k, cfg.scale, cls_mask)


def forward_mask(model: VisionTransformer, x: torch.Tensor,
                 cls_mask: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Embed n_masks region masks by masked CLS attention in the last
    block: x (1, H, W, 3), cls_mask (n_masks, H/P, W/P) binary -> (n_masks,
    D), in O(n_masks * N) memory (reference ``forward_mask``)."""
    tokens = _tokens_before_last(model, x, cfg)
    tokens = block_apply(model.blocks[-1], tokens, cfg, cls_mask=cls_mask)[0]
    return layer_norm(model.norm, tokens, cfg.ln_eps)[0]


def get_intermediate_layers(model: VisionTransformer, x: torch.Tensor,
                            cfg: ViTConfig, n: int = 1) -> List[torch.Tensor]:
    """The final-LayerNorm'd tokens after each of the last ``n`` blocks,
    (B, 1+N, D) each (reference ``get_intermediate_layers``)."""
    tokens = prepare_tokens(model, x, cfg)
    depth = len(model.blocks)
    out = []
    for i, blk in enumerate(model.blocks):
        tokens = block_apply(blk, tokens, cfg)[0]
        if depth - i <= n:
            out.append(layer_norm(model.norm, tokens, cfg.ln_eps))
    return out


def truncate_blocks(model: VisionTransformer,
                    n_blocks: int) -> VisionTransformer:
    """Keep only the first n blocks (reference ``dino.blocks = blocks[:n]``)."""
    model.blocks = nn.ModuleList(list(model.blocks)[:n_blocks])
    return model
