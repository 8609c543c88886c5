"""The DINO projection head and the multi-crop forward: the port of
``dino_tpu/models/dino_head.py``.

``DINOHead`` is an MLP (``nlayers`` linear layers, true-erf GELU between
them) to a bottleneck, an L2 normalization of the bottleneck and a
weight-normed linear layer without bias to ``out_dim`` prototypes.  The
last layer keeps ``dino_tpu``'s two leaves as two parameters: the direction
``v`` (out_dim, bottleneck_dim; the torch (out, in) layout of its
(bottleneck_dim, out_dim) kernel) and the scale ``g`` (out_dim,).  Its
weight is v * g / (||v|| + 1e-12), the norm per prototype, which is not
``torch.nn.utils.weight_norm`` (no epsilon there).  With
``norm_last_layer`` the forward reads ``g`` detached, so it gets no
gradient, but it stays a parameter for the optimizer, as ``g`` stays a
leaf of ``dino_tpu``'s optimizer tree.

Numerics follow ``dino_head_apply``: each linear layer is a product with a
float32 result plus the float32 bias (a bf16 backbone feature enters the
first layer in bf16), every later step in float32, and the bottleneck is
divided by ||x|| + 1e-12 (not ``F.normalize``'s max(||x||, eps)).
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dino_tpu_torch.models.heads import affine


class WeightNormLinear(nn.Module):
    """Bias-free linear layer with weight v * g / (||v||_row + 1e-12)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.v = nn.Parameter(torch.empty(out_dim, in_dim))
        self.g = nn.Parameter(torch.ones(out_dim))


class DINOHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, norm_last_layer: bool = True,
                 nlayers: int = 3, hidden_dim: int = 2048,
                 bottleneck_dim: int = 256):
        super().__init__()
        nlayers = max(nlayers, 1)
        self.norm_last_layer = norm_last_layer
        if nlayers == 1:
            dims = [in_dim, bottleneck_dim]
        else:
            dims = [in_dim] + [hidden_dim] * (nlayers - 1) + [bottleneck_dim]
        self.mlp = nn.ModuleList(nn.Linear(a, b)
                                 for a, b in zip(dims[:-1], dims[1:]))
        self.last_layer = WeightNormLinear(bottleneck_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dino_head_apply(self, x)


@torch.no_grad()
def init_dino_head(head: DINOHead, generator: torch.Generator) -> DINOHead:
    """``dino_tpu``'s init distributions: truncated normal (std .02, cut at
    2 std) for the linear kernels and ``v``, zero biases, ``g`` ones.
    Draws from ``generator`` on the CPU."""
    def tn(t):
        nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04,
                              generator=generator)

    for lin in head.mlp:
        tn(lin.weight)
        nn.init.zeros_(lin.bias)
    tn(head.last_layer.v)
    nn.init.ones_(head.last_layer.g)
    return head


def dino_head_apply(head: DINOHead, x: torch.Tensor) -> torch.Tensor:
    """(M, in_dim) features -> (M, out_dim) float32 logits."""
    return dino_head_last(head, dino_head_mlp(head, x))


def dino_head_mlp(head: DINOHead, x: torch.Tensor) -> torch.Tensor:
    """The MLP to the bottleneck and its L2 normalization (FSDP's first
    unit of the head)."""
    n = len(head.mlp)
    for i, lin in enumerate(head.mlp):
        x = affine(lin, x)
        if i < n - 1:
            x = F.gelu(x, approximate="none")
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def dino_head_last(head: DINOHead, x: torch.Tensor) -> torch.Tensor:
    """The weight-normed last layer over normalized bottleneck features
    (FSDP's second unit of the head)."""
    v = head.last_layer.v.float()
    g = head.last_layer.g.float()
    if head.norm_last_layer:
        g = g.detach()
    w = v * (g / (torch.linalg.vector_norm(v, dim=1) + 1e-12))[:, None]
    return F.linear(x, w)


def crop_groups(crops: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Consecutive crops of one resolution concatenated into one batch, in
    order (MultiCropWrapper's grouping)."""
    if not isinstance(crops, (list, tuple)):
        crops = [crops]
    groups = []
    start = 0
    while start < len(crops):
        res = crops[start].shape[1]
        end = start
        while end < len(crops) and crops[end].shape[1] == res:
            end += 1
        groups.append(torch.cat(list(crops[start:end]), dim=0))
        start = end
    return groups


def multi_crop_forward(backbone_fn: Callable, head_fn: Callable,
                       crops: Sequence[torch.Tensor]) -> torch.Tensor:
    """MultiCropWrapper: consecutive crops of one resolution go through the
    backbone as one batch, the CLS features of every group are
    concatenated and the head runs once.  ``backbone_fn((B, H, W, 3)) ->
    (B, D)``, ``head_fn((M, D)) -> (M, K)``."""
    return head_fn(torch.cat([backbone_fn(g) for g in crop_groups(crops)],
                             dim=0))
