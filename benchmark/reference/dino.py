"""DINO pretraining steps, plain (facebookresearch/dino ``main_dino.py``,
``vision_transformer.py:DINOHead``, ``utils.py``).

One step over a batch of B images, each 2 global and n local crops
(uint8, (2, B, G, G, 3) and (n, B, L, L, 3)):

  * the student runs every crop (crops of one size as one batch, the
    MultiCropWrapper), the teacher the two globals with no gradient; a
    network is the ViT's final-normed CLS token, then the DINO head: an
    erf-GELU MLP to the bottleneck, L2 normalization, and a weight-normed
    linear layer without bias, w = g * v / ||v|| by prototype row, its
    g held at 1 (``norm_last_layer``);
  * DINOLoss: the teacher's softmax((t - centre) / teacher_temp) against
    the student's log_softmax(s / student_temp), summed over classes,
    averaged over the batch, over the ordered pairs of a global teacher
    view and a different student view;
  * backward; each parameter's gradient scaled by min(1, clip /
    (||grad|| + 1e-6)) (``clip_gradients``); AdamW (torch's: decay first,
    p *= 1 - lr * wd, on parameters of two or more dimensions; bias-
    corrected moments, eps outside the square root); the teacher's EMA
    over every parameter; the centre's EMA toward the teacher's batch
    mean.

The step runs in microbatches of rows (the loss is a mean over the
batch's rows, so the gradients of the parts sum to the whole's), so that
the float32 step fits on the card at the benchmark's batch.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import vit
from benchmark.reference.lowp import linear, matmul

BETAS = (0.9, 0.999)
EPS = 1e-8


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    s = vit.param_shapes(cfg, "vit.")
    dims = ([cfg["embed_dim"]] + [cfg["hidden_dim"]] * (cfg["head_layers"] - 1)
            + [cfg["bottleneck_dim"]])
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        s[f"head.mlp.{i}.weight"] = (b, a)
        s[f"head.mlp.{i}.bias"] = (b,)
    s["head.last_layer.v"] = (cfg["out_dim"], cfg["bottleneck_dim"])
    s["head.last_layer.g"] = (cfg["out_dim"],)
    return s


def head(p: dict, x: torch.Tensor, cfg: dict, fp8: bool) -> torch.Tensor:
    n = cfg["head_layers"]
    for i in range(n):
        x = linear(x, p[f"head.mlp.{i}.weight"], p[f"head.mlp.{i}.bias"],
                   fp8)
        if i < n - 1:
            x = F.gelu(x)
    x = F.normalize(x, dim=-1, p=2)
    v = p["head.last_layer.v"]
    g = p["head.last_layer.g"].detach()
    w = v * (g / v.norm(dim=1))[:, None]
    return matmul(x, w.t(), fp8)


def network(p: dict, crops: List[torch.Tensor], cfg: dict,
            fp8: bool) -> torch.Tensor:
    """Normalized crops (each (B, S, S, 3)) -> (len(crops) * B, out_dim)
    logits, crops of one size through the backbone as one batch."""
    feats, start = [], 0
    while start < len(crops):
        end = start
        while end < len(crops) and crops[end].shape[1] == crops[start].shape[1]:
            end += 1
        x = torch.cat(crops[start:end], dim=0)
        feats.append(vit.forward(p, "vit.", x, cfg, fp8)[:, 0])
        start = end
    return head(p, torch.cat(feats, dim=0), cfg, fp8)


def dino_loss(s_out, t_out, center, cfg: dict) -> torch.Tensor:
    n_crops = 2 + cfg["local_crops_number"]
    s = (s_out / cfg["student_temp"]).chunk(n_crops)
    t = F.softmax((t_out - center) / cfg["teacher_temp"], dim=-1)
    t = t.detach().chunk(2)
    total, terms = 0.0, 0
    for iq, q in enumerate(t):
        for v in range(n_crops):
            if v == iq:
                continue
            total = total + torch.sum(-q * F.log_softmax(s[v], dim=-1),
                                      dim=-1).mean()
            terms += 1
    return total / terms


def run_steps(weights: Dict[str, torch.Tensor],
              batches: List[Tuple[torch.Tensor, torch.Tensor]], cfg: dict,
              microbatch: int, fp8: bool = False) -> dict:
    """Steps from ``weights`` (student = teacher at the start, centre 0)
    over ``batches`` of (global, local) uint8 crops.  Returns per step the
    loss, the first step's clipped gradient of each leaf, and after the
    last step each leaf's change in the student and the teacher and the
    centre (tensors on the weights' device)."""
    lr, wd, clip = cfg["lr"], cfg["weight_decay"], cfg["clip_grad"]
    m_t, m_c = cfg["momentum_teacher"], cfg["center_momentum"]
    frozen = {"head.last_layer.g"} if cfg["norm_last_layer"] else set()
    p0 = {k: w.detach().float().clone() for k, w in weights.items()}
    student = {k: w.clone().requires_grad_(k not in frozen)
               for k, w in p0.items()}
    teacher = {k: w.clone() for k, w in p0.items()}
    trained = [k for k in student if k not in frozen]
    m = {k: torch.zeros_like(p0[k]) for k in trained}
    v2 = {k: torch.zeros_like(p0[k]) for k in trained}
    center = torch.zeros(1, cfg["out_dim"], device=next(iter(p0.values())).device)
    losses, first_grads = [], {}
    with vit.no_tf32():
        for t, (g_u8, l_u8) in enumerate(batches, start=1):
            b = g_u8.shape[1]
            loss_sum, t_sum = 0.0, 0.0
            for s0 in range(0, b, microbatch):
                rows = slice(s0, s0 + microbatch)
                gl = [vit.normalize(c[rows]) for c in g_u8]
                lo = [vit.normalize(c[rows]) for c in l_u8]
                with torch.no_grad():
                    t_out = network(teacher, gl, cfg, fp8)
                s_out = network(student, gl + lo, cfg, fp8)
                loss = dino_loss(s_out, t_out, center, cfg)
                share = gl[0].shape[0] / b
                (loss * share).backward()
                loss_sum += float(loss.detach()) * share
                t_sum = t_sum + t_out.sum(dim=0, keepdim=True)
            losses.append(loss_sum)
            with torch.no_grad():
                for k in trained:
                    gr = student[k].grad
                    gr.mul_(torch.clamp(clip / (gr.norm() + 1e-6), max=1.0))
                    if t == 1:
                        first_grads[k] = gr.clone()
                    p = student[k]
                    if p.dim() >= 2:
                        p.mul_(1 - lr * wd)
                    m[k].mul_(BETAS[0]).add_(gr, alpha=1 - BETAS[0])
                    v2[k].mul_(BETAS[1]).addcmul_(gr, gr, value=1 - BETAS[1])
                    bc1 = 1 - BETAS[0] ** t
                    bc2 = 1 - BETAS[1] ** t
                    denom = (v2[k].sqrt() / bc2 ** 0.5).add_(EPS)
                    p.addcdiv_(m[k], denom, value=-lr / bc1)
                    p.grad = None
                for k in teacher:
                    teacher[k].mul_(m_t).add_(student[k].detach(),
                                              alpha=1 - m_t)
                batch_center = t_sum / (2 * b)
                center = center * m_c + batch_center * (1 - m_c)
    zero = {k: torch.zeros_like(p0[k]) for k in frozen}
    return {"losses": losses, "first_grads": {**first_grads, **zero},
            "moves": {k: student[k].detach() - p0[k] for k in p0},
            "teacher_moves": {k: teacher[k] - p0[k] for k in p0},
            "center": center}
