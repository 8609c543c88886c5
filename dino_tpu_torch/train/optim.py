"""Optimizer utilities for DINO pretraining: the port of
``dino_tpu/train/optim.py`` (the reference's ``clip_gradients``, LARS and
``get_params_groups``).

Each of the port's parameters is one leaf of ``dino_tpu``'s parameter tree
(a transposed or reshaped copy at most), so the per-leaf norms below are
the same numbers.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple, Union

import torch
import torch.nn as nn


def clip_gradients(grads: List[torch.Tensor], clip: float,
                   norms: Optional[List[torch.Tensor]] = None
                   ) -> List[torch.Tensor]:
    """DINO's per-parameter clip, in place: each gradient is scaled by
    min(1, clip / (||g|| + 1e-6)), its own L2 norm, not the global one.
    ``norms`` gives the norms when ``grads`` are shards of the leaves
    (``parallel/mesh.py:gradient_norms``).  Returns the norms (float32
    0-dim tensors, on the gradients' device; no host sync)."""
    if not grads:
        return []
    if norms is None:
        norms = [torch.linalg.vector_norm(g.float()) for g in grads]
    scales = [torch.clamp(clip / (n + 1e-6), max=1.0) for n in norms]
    torch._foreach_mul_(grads, scales)
    return norms


class LARS(torch.optim.Optimizer):
    """LARS with DINO's semantics: weight decay and the trust ratio
    eta * ||p|| / (||g|| + 1e-12) (1 where either norm is 0) apply to
    parameters of 2 or more dimensions only; the others take plain SGD
    with momentum.  ``lr`` may be a function of the step count (1 at the
    first step), as an optax schedule."""

    def __init__(self, params, lr: Union[float, Callable[[int], float]],
                 momentum: float = 0.9, weight_decay: float = 0.0,
                 eta: float = 0.001):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay, eta=eta))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["count"] = 0
                    state["momentum"] = torch.zeros_like(p, dtype=torch.float32)
                state["count"] += 1
                lr = group["lr"]
                lr = lr(state["count"]) if callable(lr) else lr
                g = p.grad.float()
                if p.dim() > 1:
                    g = g + group["weight_decay"] * p
                    p_norm = torch.linalg.vector_norm(p.float())
                    g_norm = torch.linalg.vector_norm(g)
                    trust = torch.where((p_norm > 0) & (g_norm > 0),
                                        group["eta"] * p_norm
                                        / (g_norm + 1e-12),
                                        torch.ones_like(p_norm))
                    g = g * trust
                m = state["momentum"]
                m.mul_(group["momentum"]).add_(g)
                p.add_((-lr * m).to(p.dtype))
        return loss


def get_params_groups(model: Union[nn.Module,
                                   Iterable[Tuple[str, torch.Tensor]]]):
    """The reference's two parameter groups: parameters of 2 or more
    dimensions (regularized), then biases and other 1-D parameters
    (``weight_decay`` 0).  Frozen parameters are left out, as the
    reference's ``requires_grad`` filter does."""
    named = (model.named_parameters() if isinstance(model, nn.Module)
             else model)
    regularized, not_regularized = [], []
    for _, p in named:
        if not p.requires_grad:
            continue
        (regularized if p.dim() > 1 else not_regularized).append(p)
    return [{"params": regularized}, {"params": not_regularized,
                                      "weight_decay": 0.0}]
