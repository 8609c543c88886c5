"""The DINO Vision Transformer, plain (facebookresearch/dino
``vision_transformer.py``): patch embedding, the CLS token, the position
embedding resampled by bicubic interpolation with the +0.1 guard, pre-LN
blocks (softmax attention, erf-GELU MLP), the final LayerNorm.

Parameters are a dict of float32 tensors under the names
:func:`param_shapes` gives (``<prefix>blocks.<i>.attn.qkv.weight``, ...;
a weight is (out, in)).  Images are (B, H, W, 3) normalized float32.
The patch embedding (a stride-P convolution upstream) is the same sum as
a product over each patch's (c, ph, pw) pixels.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.lowp import linear, matmul

# query rows per attention block: (B, heads, rows, N) scores at a time
ATTN_ROWS = 1024


def param_shapes(cfg: dict, prefix: str) -> Dict[str, Tuple[int, ...]]:
    d, p = cfg["embed_dim"], cfg["patch_size"]
    h = int(d * cfg["mlp_ratio"])
    grid = cfg["img_size"] // p
    s = {f"{prefix}cls_token": (1, 1, d),
         f"{prefix}pos_embed": (1, grid * grid + 1, d),
         f"{prefix}patch_embed.proj.weight": (d, 3, p, p),
         f"{prefix}patch_embed.proj.bias": (d,)}
    for i in range(cfg["depth"]):
        b = f"{prefix}blocks.{i}."
        s.update({b + "norm1.weight": (d,), b + "norm1.bias": (d,),
                  b + "attn.qkv.weight": (3 * d, d),
                  b + "attn.qkv.bias": (3 * d,),
                  b + "attn.proj.weight": (d, d), b + "attn.proj.bias": (d,),
                  b + "norm2.weight": (d,), b + "norm2.bias": (d,),
                  b + "mlp.fc1.weight": (h, d), b + "mlp.fc1.bias": (h,),
                  b + "mlp.fc2.weight": (d, h), b + "mlp.fc2.bias": (d,)})
    s.update({f"{prefix}norm.weight": (d,), f"{prefix}norm.bias": (d,)})
    return s


def interpolate_pos_encoding(pos: torch.Tensor, h: int, w: int,
                             patch: int) -> torch.Tensor:
    """Upstream ``interpolate_pos_encoding``: the patch grid's embedding
    resampled bicubically to (h/P, w/P), the scale taken from (h/P + 0.1)
    to avoid a floating-point error in the size."""
    n = pos.shape[1] - 1
    if (h // patch) * (w // patch) == n and w == h:
        return pos
    dim = pos.shape[-1]
    w0, h0 = w // patch + 0.1, h // patch + 0.1
    side = int(math.sqrt(n))
    grid = pos[:, 1:].reshape(1, side, side, dim).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=(w0 / math.sqrt(n),
                                             h0 / math.sqrt(n)),
                         mode="bicubic")
    grid = grid.permute(0, 2, 3, 1).reshape(1, -1, dim)
    return torch.cat([pos[:, :1], grid], dim=1)


def patch_embed(p: dict, prefix: str, x: torch.Tensor, patch: int,
                fp8: bool) -> torch.Tensor:
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    cols = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 5, 2, 4)
    cols = cols.reshape(b, gh * gw, c * patch * patch)
    wt = p[f"{prefix}patch_embed.proj.weight"]
    return linear(cols, wt.reshape(wt.shape[0], -1),
                  p[f"{prefix}patch_embed.proj.bias"], fp8)


def attention(p: dict, pre: str, x: torch.Tensor, heads: int,
              fp8: bool) -> torch.Tensor:
    b, n, c = x.shape
    hd = c // heads
    qkv = linear(x, p[pre + "qkv.weight"], p[pre + "qkv.bias"], fp8)
    qkv = qkv.reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    kt = k.transpose(-2, -1)
    outs = []
    for s in range(0, n, ATTN_ROWS):
        scores = matmul(q[:, :, s:s + ATTN_ROWS], kt, fp8) * hd ** -0.5
        outs.append(matmul(scores.softmax(dim=-1), v, fp8))
    out = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, n, c)
    return linear(out, p[pre + "proj.weight"], p[pre + "proj.bias"], fp8)


def block(p: dict, pre: str, x: torch.Tensor, cfg: dict,
          fp8: bool) -> torch.Tensor:
    d, eps = cfg["embed_dim"], cfg["ln_eps"]
    y = F.layer_norm(x, (d,), p[pre + "norm1.weight"], p[pre + "norm1.bias"],
                     eps)
    x = x + attention(p, pre + "attn.", y, cfg["num_heads"], fp8)
    y = F.layer_norm(x, (d,), p[pre + "norm2.weight"], p[pre + "norm2.bias"],
                     eps)
    y = F.gelu(linear(y, p[pre + "mlp.fc1.weight"], p[pre + "mlp.fc1.bias"],
                      fp8))
    return x + linear(y, p[pre + "mlp.fc2.weight"], p[pre + "mlp.fc2.bias"],
                      fp8)


def forward(p: dict, prefix: str, x: torch.Tensor, cfg: dict,
            fp8: bool = False) -> torch.Tensor:
    """Normalized images (B, H, W, 3) -> (B, 1+N, D) tokens after the
    final LayerNorm."""
    b, h, w, _ = x.shape
    patch = cfg["patch_size"]
    tokens = patch_embed(p, prefix, x, patch, fp8)
    cls = p[f"{prefix}cls_token"].expand(b, -1, -1)
    tokens = torch.cat([cls, tokens], dim=1)
    tokens = tokens + interpolate_pos_encoding(p[f"{prefix}pos_embed"], h, w,
                                               patch)
    for i in range(cfg["depth"]):
        tokens = block(p, f"{prefix}blocks.{i}.", tokens, cfg, fp8)
    d = cfg["embed_dim"]
    return F.layer_norm(tokens, (d,), p[f"{prefix}norm.weight"],
                        p[f"{prefix}norm.bias"], cfg["ln_eps"])


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 or float pixels (..., 3) in [0, 255] -> ImageNet-normalized
    float32 (albumentations ``Normalize``, torchvision's mean and std)."""
    mean = torch.tensor(IMAGENET_MEAN, device=img_u8.device)
    std = torch.tensor(IMAGENET_STD, device=img_u8.device)
    return (img_u8.float() / 255.0 - mean) / std


class no_tf32:
    """Float32 products in true float32 inside the block (cuBLAS and
    cuDNN), restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32,
                      torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, prec) = self.saved
        torch.set_float32_matmul_precision(prec)
        return False
