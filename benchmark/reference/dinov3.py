"""The DINOv3 segmentation model, plain (facebookresearch/dinov3
``vision_transformer.py`` and ``layers/``): camera frame -> log-probs.

uint8 (B, H, W, 3) frames -> ``seg.resize`` to the square inference
resolution -> ``vit.normalize`` -> patch embedding -> [CLS, storage tokens,
patches] (no position embedding) -> blocks -> final LayerNorm over every
token -> patch tokens -> the MLP head -> log-softmax.  A block:

    x = x + ls1 * Attn(LN1(x)),   x = x + ls2 * w3(silu(w1 LN2(x)) * w2 LN2(x))

Attn: qkv = Linear(D, 3D) with the k third of its bias at 0; q and k of the
patch rows (not the prefix) rotated in float32, t cos + rotate_half(t) sin
with rotate_half(t) = [-t[hd/2:], t[:hd/2]], by the table of
:func:`rope_table` (the source's ``RopePositionEmbedding``: base 100,
``normalize_coords='separate'``); softmax attention; proj.

Departures from the source, none of which changes a value at inference:
the k bias is held at zero (the source multiplies it by a mask of zeros,
``LinearKMaskedBias``); the table is computed on the CPU in float32 and
copied, not on the device; the source's coordinate augmentations
(``rescale_coords``, shift, jitter) act only in training and are left out;
``cls_token + 0 * mask_token`` is ``cls_token``; the patch embedding (a
stride-P convolution upstream) is the same sum as a product over each
patch's pixels; the LayerNorms (``layernormbf16`` upstream) run in
float32, as everything here does (TF32 off).  Products are ``lowp.linear``
and ``lowp.matmul``: float32, or fp8 e4m3 for the control.

Parameters are a dict of float32 tensors under :func:`param_shapes`' names,
the source's (``dino.blocks.<i>.ls1.gamma``, ``dino.blocks.<i>.mlp.w1``,
``dino.storage_tokens``, ...), the head's under ``clf.``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import seg, vit
from benchmark.reference.lowp import linear, matmul


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    d, p, h = cfg["embed_dim"], cfg["patch_size"], cfg["ffn_hidden"]
    s = {"dino.cls_token": (1, 1, d),
         "dino.storage_tokens": (1, cfg["n_storage_tokens"], d),
         "dino.mask_token": (1, d),
         "dino.patch_embed.proj.weight": (d, 3, p, p),
         "dino.patch_embed.proj.bias": (d,)}
    for i in range(cfg["depth"]):
        b = f"dino.blocks.{i}."
        s.update({b + "norm1.weight": (d,), b + "norm1.bias": (d,),
                  b + "attn.qkv.weight": (3 * d, d),
                  b + "attn.qkv.bias": (3 * d,),
                  b + "attn.proj.weight": (d, d), b + "attn.proj.bias": (d,),
                  b + "ls1.gamma": (d,),
                  b + "norm2.weight": (d,), b + "norm2.bias": (d,),
                  b + "mlp.w1.weight": (h, d), b + "mlp.w1.bias": (h,),
                  b + "mlp.w2.weight": (h, d), b + "mlp.w2.bias": (h,),
                  b + "mlp.w3.weight": (d, h), b + "mlp.w3.bias": (d,),
                  b + "ls2.gamma": (d,)})
    s.update({"dino.norm.weight": (d,), "dino.norm.bias": (d,)})
    dims = cfg["head_dims"]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        s[f"clf.layer_{i + 1}.weight"] = (b, a)
        s[f"clf.layer_{i + 1}.bias"] = (b,)
    return s


def rope_table(gh: int, gw: int, head_dim: int, base: float, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), (gh * gw, head_dim) float32: periods base^(2j/(hd/2)),
    j < hd/4; patch (i, j) at (2 (i + 0.5)/gh - 1, 2 (j + 0.5)/gw - 1);
    angles 2 pi c / period, h's then w's, tiled twice."""
    periods = base ** (2 * torch.arange(head_dim // 4, dtype=torch.float32)
                       / (head_dim // 2))
    ch = torch.arange(0.5, gh, dtype=torch.float32) / gh
    cw = torch.arange(0.5, gw, dtype=torch.float32) / gw
    coords = torch.stack(torch.meshgrid(ch, cw, indexing="ij"), dim=-1)
    coords = 2.0 * coords.flatten(0, 1) - 1.0
    angles = 2 * math.pi * coords[:, :, None] / periods[None, None, :]
    angles = angles.flatten(1, 2).tile(2)
    return torch.cos(angles).to(device), torch.sin(angles).to(device)


def rope_apply(t: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    half = t.shape[-1] // 2
    rot = torch.cat([-t[..., half:], t[..., :half]], dim=-1)
    return t * cos + rot * sin


def attention(p: dict, pre: str, x: torch.Tensor, cfg: dict, rope,
              fp8: bool) -> torch.Tensor:
    b, n, c = x.shape
    heads = cfg["num_heads"]
    hd = c // heads
    prefix = 1 + cfg["n_storage_tokens"]
    bias = p[pre + "qkv.bias"].clone()
    bias[c:2 * c] = 0.0  # mask_k_bias
    qkv = linear(x, p[pre + "qkv.weight"], bias, fp8)
    qkv = qkv.reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    cos, sin = rope
    q, k, v = [torch.cat([t[:, :, :prefix],
                          rope_apply(t[:, :, prefix:], cos, sin)], dim=2)
               if i < 2 else t for i, t in enumerate(qkv)]
    kt = k.transpose(-2, -1)
    outs = []
    for s in range(0, n, vit.ATTN_ROWS):
        scores = matmul(q[:, :, s:s + vit.ATTN_ROWS], kt, fp8) * hd ** -0.5
        outs.append(matmul(scores.softmax(dim=-1), v, fp8))
    out = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, n, c)
    return linear(out, p[pre + "proj.weight"], p[pre + "proj.bias"], fp8)


def block(p: dict, pre: str, x: torch.Tensor, cfg: dict, rope,
          fp8: bool) -> torch.Tensor:
    d, eps = cfg["embed_dim"], cfg["ln_eps"]
    y = F.layer_norm(x, (d,), p[pre + "norm1.weight"], p[pre + "norm1.bias"],
                     eps)
    x = x + p[pre + "ls1.gamma"] * attention(p, pre + "attn.", y, cfg, rope,
                                             fp8)
    y = F.layer_norm(x, (d,), p[pre + "norm2.weight"], p[pre + "norm2.bias"],
                     eps)
    m = pre + "mlp."
    y = (F.silu(linear(y, p[m + "w1.weight"], p[m + "w1.bias"], fp8))
         * linear(y, p[m + "w2.weight"], p[m + "w2.bias"], fp8))
    y = linear(y, p[m + "w3.weight"], p[m + "w3.bias"], fp8)
    return x + p[pre + "ls2.gamma"] * y


def forward(p: dict, x: torch.Tensor, cfg: dict,
            fp8: bool = False) -> torch.Tensor:
    """Normalized images (B, H, W, 3) -> (B, 1 + storage + N, D) tokens
    after the final LayerNorm."""
    b, h, w, _ = x.shape
    patch = cfg["patch_size"]
    tokens = vit.patch_embed(p, "dino.", x, patch, fp8)
    tokens = torch.cat([p["dino.cls_token"].expand(b, -1, -1),
                        p["dino.storage_tokens"].expand(b, -1, -1), tokens],
                       dim=1)
    rope = rope_table(h // patch, w // patch,
                      cfg["embed_dim"] // cfg["num_heads"], cfg["rope_base"],
                      x.device)
    for i in range(cfg["depth"]):
        tokens = block(p, f"dino.blocks.{i}.", tokens, cfg, rope, fp8)
    d = cfg["embed_dim"]
    return F.layer_norm(tokens, (d,), p["dino.norm.weight"],
                        p["dino.norm.bias"], cfg["ln_eps"])


def log_probs(p: dict, frames_u8: torch.Tensor, cfg: dict, res: int,
              fp8: bool = False) -> torch.Tensor:
    """(B, grid, grid, n_classes) float32 log-probabilities."""
    with torch.no_grad(), vit.no_tf32():
        x = vit.normalize(seg.resize(frames_u8, res))
        feats = forward(p, x, cfg, fp8)[:, 1 + cfg["n_storage_tokens"]:]
        n = len(cfg["head_dims"]) - 1
        for i in range(n):
            feats = linear(feats, p[f"clf.layer_{i + 1}.weight"],
                           p[f"clf.layer_{i + 1}.bias"], fp8)
            if i < n - 1:
                feats = torch.relu(feats)
        grid = res // cfg["patch_size"]
        return feats.log_softmax(dim=-1).reshape(frames_u8.shape[0], grid,
                                                 grid, -1)
