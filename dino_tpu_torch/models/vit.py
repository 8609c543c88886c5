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
  * under FSDP (``parallel/mesh.py``) :func:`vit_forward_units` runs the
    same forward one unit (:func:`vit_units`) gathered at a time, every
    unit recomputed in its backward;
  * ``get_last_selfattention`` (full, masked or CLS-row only),
    ``forward_mask`` and ``get_intermediate_layers`` run the earlier blocks
    as ``vit_forward`` does and the last block's attention through its
    materialized probabilities (``ops.attention.attention_probs``);
  * a DINOv3 configuration (:func:`dinov3_vith16plus`; facebookresearch/
    dinov3 ``vision_transformer.py``) puts ``n_storage_tokens`` after CLS
    and no position embedding before the blocks, rotates q and k of the
    patch rows by 2-D RoPE (:func:`rope_table`, applied in
    ``ops/qkv_rope.py``), scales each branch by a per-channel LayerScale
    and runs a SwiGLU MLP (``ops/swiglu.py``); its parameters carry the
    source's names (``storage_tokens``, ``mask_token``,
    ``blocks.{i}.ls1.gamma``, ``blocks.{i}.mlp.w1``/``w2``/``w3``).  Such a
    model runs forwards only (no int8, no parallel mode, no attention
    maps).
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

from dino_tpu_torch.models.heads import affine, affine_t, dense
from dino_tpu_torch.ops.attention import (attention_probs,
                                          multi_head_attention)
from dino_tpu_torch.ops import bias_gelu
from dino_tpu_torch.ops.bicubic import bicubic_resize_matrix
from dino_tpu_torch.ops import swiglu as swiglu_ops
from dino_tpu_torch.ops.fused_mlp import fused_ln_mlp_residual, takes_widths
from dino_tpu_torch.ops.quant import QuantLinear, int8_dense
from dino_tpu_torch.parallel.mesh import run_unit
from dino_tpu_torch.utils.profiling import annotate


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
    # DINOv3: ffn_hidden > 0 runs the SwiGLU MLP w3(silu(w1 x) * w2 x) of
    # that hidden width in place of fc2(gelu(fc1 x)); n_storage_tokens sit
    # after CLS; layerscale scales each branch by a per-channel gamma;
    # rope_base > 0 rotates q and k of the patch rows (RoPE) in place of a
    # learned position embedding, and holds the k third of qkv's bias at 0
    # (the source's mask_k_bias)
    ffn_hidden: int = 0
    n_storage_tokens: int = 0
    layerscale: bool = False
    rope_base: float = 0.0

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
        return self.ffn_hidden or int(self.embed_dim * self.mlp_ratio)

    @property
    def rope(self) -> bool:
        return self.rope_base > 0

    @property
    def num_prefix(self) -> int:
        """Tokens before the patches: CLS and the storage tokens."""
        return 1 + self.n_storage_tokens


def vit_tiny(patch_size: int = 16, **kw) -> ViTConfig:
    return ViTConfig(patch_size=patch_size, embed_dim=192, depth=12, num_heads=3, **kw)


def vit_small(patch_size: int = 16, **kw) -> ViTConfig:
    return ViTConfig(patch_size=patch_size, embed_dim=384, depth=12, num_heads=6, **kw)


def vit_base(patch_size: int = 16, **kw) -> ViTConfig:
    return ViTConfig(patch_size=patch_size, embed_dim=768, depth=12, num_heads=12, **kw)


def swiglu_hidden(dim: int, ffn_ratio: float, align: int = 8) -> int:
    """The source's ``SwiGLUFFN`` width: 2/3 of ``dim * ffn_ratio``, rounded
    up to a multiple of ``align``."""
    d = int(int(dim * ffn_ratio) * 2 / 3)
    return d + (-d % align)


def dinov3_vith16plus(**kw) -> ViTConfig:
    """DINOv3 ViT-H+/16 (facebookresearch/dinov3
    ``dinov3/hub/backbones.py:dinov3_vith16plus``): D 1,280, 32 blocks, 20
    heads of 64, SwiGLU of width 5,120 (``ffn_ratio`` 6), 4 storage tokens,
    LayerScale, RoPE of base 100 on q and k of the patch rows (the k bias
    masked), LayerNorm eps 1e-5."""
    kw = {"patch_size": 16, "embed_dim": 1280, "depth": 32, "num_heads": 20,
          "mlp_ratio": 6.0, "ln_eps": 1e-5,
          "ffn_hidden": swiglu_hidden(1280, 6.0), "n_storage_tokens": 4,
          "layerscale": True, "rope_base": 100.0, **kw}
    return ViTConfig(**kw)


# DINOSeg's ViT backbones by name ('vit' is the product's DINO ViT-S/8)
VIT_BACKBONES = {"vit": functools.partial(ViTConfig, patch_size=8),
                 "dinov3_vith16plus": dinov3_vith16plus}


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


class SwiGLUFFN(nn.Module):
    """The source's ``SwiGLUFFN``: w3(silu(w1 x) * w2 x)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.w1 = nn.Linear(cfg.embed_dim, cfg.mlp_hidden)
        self.w2 = nn.Linear(cfg.embed_dim, cfg.mlp_hidden)
        self.w3 = nn.Linear(cfg.mlp_hidden, cfg.embed_dim)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.attn = Attention(cfg)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.mlp = SwiGLUFFN(cfg) if cfg.ffn_hidden else Mlp(cfg)
        if cfg.layerscale:
            self.ls1 = LayerScale(cfg.embed_dim)
            self.ls2 = LayerScale(cfg.embed_dim)


class VisionTransformer(nn.Module):
    """Parameters of a (possibly truncated) DINO ViT; ``forward`` is
    :func:`vit_forward`."""

    def __init__(self, cfg: ViTConfig, depth: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        depth = cfg.depth if depth is None else depth
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        if cfg.n_storage_tokens:
            self.storage_tokens = nn.Parameter(
                torch.zeros(1, cfg.n_storage_tokens, cfg.embed_dim))
        if cfg.rope:
            # the source's masked-image token, unused by a forward
            self.mask_token = nn.Parameter(torch.zeros(1, cfg.embed_dim))
        else:
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
    LayerNorm ones/zeros.  DINOv3: the storage tokens as CLS, the mask
    token zero, LayerScale's gamma at the source's 1e-5.  Draws from
    ``generator`` on the CPU."""
    def tn(t):
        nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04,
                              generator=generator)

    tn(model.cls_token)
    for name in ("storage_tokens", "pos_embed"):
        if hasattr(model, name):
            tn(getattr(model, name))
    if hasattr(model, "mask_token"):
        nn.init.zeros_(model.mask_token)
    proj = model.patch_embed.proj
    bound = 1.0 / math.sqrt(proj.weight[0].numel())
    nn.init.uniform_(proj.weight, -bound, bound, generator=generator)
    nn.init.uniform_(proj.bias, -bound, bound, generator=generator)
    for blk in model.blocks:
        for lin in (blk.attn.qkv, blk.attn.proj,
                    *(m for m in blk.mlp.children())):
            tn(lin.weight)
            nn.init.zeros_(lin.bias)
        for ln in (blk.norm1, blk.norm2):
            nn.init.ones_(ln.weight)
            nn.init.zeros_(ln.bias)
        for ls in (getattr(blk, "ls1", None), getattr(blk, "ls2", None)):
            if ls is not None:
                nn.init.constant_(ls.gamma, 1e-5)
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
    """(B, H, W, 3) image -> (B, prefix + N, D) tokens: patchify, then CLS
    (and the storage tokens) before the patches, then the position
    embedding, where the model has one (a RoPE model rotates q and k in
    its blocks instead)."""
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
    prefix = [model.cls_token.to(x.dtype).expand(b, 1, cfg.embed_dim)]
    if cfg.n_storage_tokens:
        prefix.append(model.storage_tokens.to(x.dtype).expand(
            b, cfg.n_storage_tokens, cfg.embed_dim))
    tokens = torch.cat(prefix + [patches], dim=1)
    if cfg.rope:
        return tokens
    pos = interpolate_pos_encoding(model.pos_embed, h, w, cfg.patch_size)
    return tokens + pos.to(tokens.dtype)


@functools.lru_cache(maxsize=None)
def _rope_table_cpu(gh: int, gw: int, head_dim: int, base: float):
    """:func:`rope_table` on the CPU (the same float32 bits on every
    machine)."""
    dd = dict(dtype=torch.float32)
    periods = base ** (2 * torch.arange(head_dim // 4, **dd)
                       / (head_dim // 2))
    coords = torch.stack(torch.meshgrid(torch.arange(0.5, gh, **dd) / gh,
                                        torch.arange(0.5, gw, **dd) / gw,
                                        indexing="ij"), dim=-1).flatten(0, 1)
    coords = 2.0 * coords - 1.0
    angles = 2 * math.pi * coords[:, :, None] / periods[None, None, :]
    angles = angles.flatten(1, 2).tile(2)
    return torch.cos(angles), torch.sin(angles)


# rope_table per (gh, gw, head_dim, base, device), copied to the device once
# (as the pos-embed matrices): no copy per call, which a CUDA graph could not
# capture
_DEVICE_ROPE: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def rope_table(gh: int, gw: int, cfg: ViTConfig, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (gh * gw, head_dim) float32 on ``device``: the
    source's ``RopePositionEmbedding`` (``normalize_coords='separate'``, no
    training augmentation) for a gh x gw patch grid.  Patch (i, j) sits at
    c_h = 2 (i + 0.5) / gh - 1, c_w = 2 (j + 0.5) / gw - 1; with periods
    p_k = base^(2k / (hd/2)), k < hd/4, its angles 2 pi c / p, h's then w's,
    are tiled twice over the head's hd channels."""
    key = (gh, gw, cfg.head_dim, float(cfg.rope_base), torch.device(device))
    if key not in _DEVICE_ROPE:
        _DEVICE_ROPE[key] = tuple(t.to(device) for t in _rope_table_cpu(
            gh, gw, cfg.head_dim, float(cfg.rope_base)))
    return _DEVICE_ROPE[key]


def rope_for(cfg: ViTConfig, x: torch.Tensor):
    """The RoPE table of images ``x`` (B, H, W, 3), or None for a model
    without RoPE."""
    if not cfg.rope:
        return None
    return rope_table(x.shape[1] // cfg.patch_size,
                      x.shape[2] // cfg.patch_size, cfg, x.device)


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
    A bf16 tensor on the card runs fc1's bias, GELU and cast as one kernel
    each way (:func:`dino_tpu_torch.ops.bias_gelu.fc1_bias_gelu`, the same
    arithmetic), with or without a gradient, so a forward without one and
    its recompute under autograd give the same activation.  With a
    ``generator``, train-mode dropout after the GELU and after fc2, then
    drop-path on the branch, each where its rate is > 0."""
    dt = x.dtype
    h = layer_norm(norm, x, eps)
    if bias_gelu.applies(h, mlp.fc1.weight.shape[0]):
        h = bias_gelu.fc1_bias_gelu(h, mlp.fc1.weight.to(dt), mlp.fc1.bias)
    else:
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


def layer_scale_add(x: torch.Tensor, h: torch.Tensor,
                    ls: Optional[LayerScale]) -> torch.Tensor:
    """x + gamma * h (x + h without LayerScale): float32 arithmetic rounded
    once to x's dtype, gamma taken in that dtype (a weight, as the dense
    layers' are)."""
    if ls is None:
        return x + h
    return torch.addcmul(x, h, ls.gamma.to(x.dtype))


def swiglu_mlp_residual(blk: Block, x: torch.Tensor,
                        eps: float) -> torch.Tensor:
    """x + ls2 * w3(silu(w1 LN(x)) * w2 LN(x)) (the ``vit.mlp`` span): LN in
    float32 -> cast; w1 and w2 as one product with a float32 result over
    their concatenation; both float32 biases, silu(a) * b in float32 and
    one rounding (``ops/swiglu.py``); w3 with its float32 bias, rounded
    once; LayerScale and the residual (:func:`layer_scale_add`)."""
    with annotate("vit.mlp", device=True):
        dt = x.dtype
        h = layer_norm(blk.norm2, x, eps)
        w12, b12 = swiglu_ops.fused_weights(blk.mlp, dt)
        y = affine_t(h, w12, None)
        h = swiglu_ops.swiglu(y.reshape(-1, y.shape[-1]), b12, dt)
        h = affine(blk.mlp.w3, h.reshape(*x.shape[:-1], -1), dt)
        return layer_scale_add(x, h, getattr(blk, "ls2", None))


def _needs_grad(blk: Block, x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in blk.parameters()))


def block_apply(blk: Block, x: torch.Tensor, cfg: ViTConfig,
                cls_mask: Optional[torch.Tensor] = None,
                need_probs: bool = False, drop_path_rate: float = 0.0,
                generator: Optional[torch.Generator] = None,
                fused_mlp: bool = True, rope=None):
    """One pre-LN transformer block; returns (x_out, probs or None).

    ``need_probs`` or a ``cls_mask`` (n_masks, gh, gw) take attention
    through the materialized probabilities; with a mask the block's output
    is one token per mask, (1, n_masks, D), over the CLS residual repeated
    per mask.  Train-mode regularization (``cfg.drop_rate``,
    ``cfg.attn_drop_rate``, ``drop_path_rate``; 0 in every reference
    config) engages only when a ``generator`` is passed and a rate is > 0.

    The fused MLP kernel runs only on the bf16 CUDA path when no gradient
    is needed, no regularization is on (the kernel has no backward) and
    ``fused_mlp`` is left on; otherwise the MLP is the differentiable
    composition :func:`mlp_residual`.  A pipeline's train step turns it off
    in the forward slots it runs without a gradient, so the activation it
    sends on is the one its backward recomputes.  A block in int8 serving form runs
    :func:`mlp_residual_int8`.  The kernel is built for D 384 only
    (``ops/fused_mlp.py:takes_widths``); other widths run the composition.

    A DINOv3 block (``cfg.rope``) takes the RoPE table of its patch grid,
    ``rope`` = (cos, sin) from :func:`rope_table`, scales both branches by
    its LayerScale and runs :func:`swiglu_mlp_residual`; it has no
    attention-map path and no train-mode regularization.
    """
    train = generator is not None and (cfg.drop_rate > 0
                                       or cfg.attn_drop_rate > 0
                                       or drop_path_rate > 0)
    if cfg.rope and (rope is None or need_probs or cls_mask is not None
                     or train):
        raise ValueError(
            "a RoPE (DINOv3) block runs forwards with its RoPE table "
            "(rope_table) and nothing else: no attention maps, masks or "
            "train-mode regularization")
    gen = generator if train else None
    y, probs = multi_head_attention(
        blk.attn, layer_norm(blk.norm1, x, cfg.ln_eps),
        num_heads=cfg.num_heads, scale=cfg.scale, cls_mask=cls_mask,
        need_probs=need_probs,
        attn_drop=(cfg.attn_drop_rate, gen) if train
        and cfg.attn_drop_rate > 0 else None,
        rope=None if rope is None else (*rope, cfg.num_prefix))
    if isinstance(blk.mlp, SwiGLUFFN):
        x = layer_scale_add(x, y, getattr(blk, "ls1", None))
        return swiglu_mlp_residual(blk, x, cfg.ln_eps), probs
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
    if (fused_mlp and not train and x.is_cuda and x.dtype == torch.bfloat16
            and not _needs_grad(blk, x)
            and takes_widths(blk.mlp, x)):
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
    rope = rope_for(cfg, x)
    for i, blk in enumerate(model.blocks):
        if remat:
            tokens = torch.utils.checkpoint.checkpoint(
                block_apply, blk, tokens, cfg, use_reentrant=False,
                rope=rope)[0]
        else:
            tokens = block_apply(blk, tokens, cfg, rope=rope)[0]
        if intermediate and i == intermediate - 1:
            return layer_norm(model.norm, tokens, cfg.ln_eps)
    tokens = layer_norm(model.norm, tokens, cfg.ln_eps)
    return tokens if all_tokens else tokens[:, 0]


def vit_units(model: VisionTransformer
              ) -> List[Tuple[str, List[nn.Parameter]]]:
    """FSDP's units of a ViT: the embeddings with the final norm
    ("root", run first and last), then each block."""
    root = [model.cls_token, model.pos_embed,
            *model.patch_embed.parameters(), *model.norm.parameters()]
    return [("root", root)] + [(f"blocks.{i}", list(blk.parameters()))
                               for i, blk in enumerate(model.blocks)]


def vit_forward_units(model: VisionTransformer,
                      chunks: List[List[torch.Tensor]], cfg: ViTConfig,
                      fsdp, *, all_tokens: bool = True
                      ) -> List[Tuple[torch.Tensor, ...]]:
    """:func:`vit_forward` of every batch of ``chunks`` (a list over a
    step's microbatches of lists of batches, e.g. a microbatch's crops of
    different resolutions) under FSDP: ``fsdp`` (a
    ``parallel/mesh.py:FSDPOptimizer``) gathers one unit of
    :func:`vit_units` at a time and runs it over every batch
    (:func:`~dino_tpu_torch.parallel.mesh.run_unit`; its backward
    recomputes the unit microbatch by microbatch).  Each batch takes the
    ops of :func:`vit_forward`, with no fused MLP under autograd (the
    backward recomputes with the composition).  Returns, per microbatch,
    the tuple of its batches' tokens; ``all_tokens=False`` normalizes and
    returns the CLS rows only."""
    train = torch.is_grad_enabled()
    root = fsdp.unit_of(model.patch_embed)
    ts = run_unit(root, lambda *xs: tuple(prepare_tokens(model, x, cfg)
                                          for x in xs), chunks)
    for blk in model.blocks:
        ts = run_unit(fsdp.unit_of(blk), lambda *ts, blk=blk: tuple(
            block_apply(blk, t, cfg, fused_mlp=not train)[0] for t in ts),
            ts)

    def final(*ts):
        if all_tokens:
            return tuple(layer_norm(model.norm, t, cfg.ln_eps) for t in ts)
        return tuple(layer_norm(model.norm, t[:, :1], cfg.ln_eps)[:, 0]
                     for t in ts)
    return run_unit(root, final, ts)


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
    rope = rope_for(cfg, x)
    depth = len(model.blocks)
    out = []
    for i, blk in enumerate(model.blocks):
        tokens = block_apply(blk, tokens, cfg, rope=rope)[0]
        if depth - i <= n:
            out.append(layer_norm(model.norm, tokens, cfg.ln_eps))
    return out


def truncate_blocks(model: VisionTransformer,
                    n_blocks: int) -> VisionTransformer:
    """Keep only the first n blocks (reference ``dino.blocks = blocks[:n]``)."""
    model.blocks = nn.ModuleList(list(model.blocks)[:n_blocks])
    return model
