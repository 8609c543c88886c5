"""Per-patch segmentation heads (MLP / Linear).

The head is a per-patch map applied after folding all patches onto the batch
axis, ending in log_softmax (float32).  Parameters carry the reference names
``layer_1``..``layer_3`` (nn.Linear, weight (out, in)); init matches
torch.nn.Linear's U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

class MLPHead(nn.Module):
    def __init__(self, n_classes: int, input_dim: int = 384):
        super().__init__()
        self.layer_1 = nn.Linear(input_dim, 200)
        self.layer_2 = nn.Linear(200, 100)
        self.layer_3 = nn.Linear(100, n_classes)


class LinearHead(nn.Module):
    def __init__(self, n_classes: int, input_dim: int = 384):
        super().__init__()
        self.layer_1 = nn.Linear(input_dim, n_classes)


@torch.no_grad()
def init_head(head_type: str, n_classes: int, input_dim: int = 384,
              generator: torch.Generator = None) -> nn.Module:
    if head_type == "mlp":
        head = MLPHead(n_classes, input_dim)
    elif head_type == "linear":
        head = LinearHead(n_classes, input_dim)
    elif head_type == "moe":
        raise NotImplementedError("the MoE head is not ported yet (ROADMAP "
                                  "'Modules to port' item 8)")
    else:
        raise ValueError(f"unknown head {head_type!r}")
    for lin in head.children():
        bound = 1.0 / math.sqrt(lin.in_features)
        nn.init.uniform_(lin.weight, -bound, bound, generator=generator)
        nn.init.uniform_(lin.bias, -bound, bound, generator=generator)
    return head


def affine(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ W^T in the input dtype, + bias in float32; float32 out."""
    return F.linear(x, lin.weight.to(x.dtype)).float() + lin.bias.float()


def mlp_head_apply(head: MLPHead, x: torch.Tensor) -> torch.Tensor:
    """(M, input_dim) -> (M, n_classes) log-probabilities."""
    x = torch.relu(affine(head.layer_1, x).to(x.dtype))
    x = torch.relu(affine(head.layer_2, x).to(x.dtype))
    return torch.log_softmax(affine(head.layer_3, x), dim=-1)


def linear_head_apply(head: LinearHead, x: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(affine(head.layer_1, x), dim=-1)


def head_apply(head_type: str, head: nn.Module,
               x: torch.Tensor) -> torch.Tensor:
    if head_type == "mlp":
        return mlp_head_apply(head, x)
    if head_type == "linear":
        return linear_head_apply(head, x)
    raise ValueError(f"unknown head {head_type!r}")
