"""The segmentation model, plain: camera frame -> 480x480 label map.

uint8 (B, H, W, 3) frames -> half-pixel bilinear resize to the square
inference resolution, rounded half up to whole pixel values (cv2
``INTER_LINEAR`` on uint8, as albumentations' ``Resize``, with exact
weights where cv2 rounds them to 11 bits) -> ImageNet normalize -> the ViT
(``vit.py``) -> patch tokens (CLS dropped) -> the MLP head (Linear, ReLU,
Linear, ReLU, Linear) -> log-softmax over the classes.  A label map is
the argmax per patch, each patch repeated over a (480 // grid)-pixel
square.

:func:`label_counts` judges maps against the reference's log-probabilities:
at every pixel, how far the reference's log-probability of the map's
label lies below its best.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.reference import vit
from benchmark.reference.lowp import linear


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    s = vit.param_shapes(cfg, "dino.")
    dims = cfg["head_dims"]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        s[f"clf.layer_{i + 1}.weight"] = (b, a)
        s[f"clf.layer_{i + 1}.bias"] = (b,)
    return s


def _taps(n_in: int, n_out: int, device):
    """Half-pixel bilinear taps of one axis, exact: the source coordinate
    (dst + 0.5) * n_in / n_out - 0.5, clamped at 0, as a fraction of
    integers, so a tap of one half is one half."""
    dst = torch.arange(n_out, device=device, dtype=torch.int64)
    num = ((2 * dst + 1) * n_in - n_out).clamp(min=0)  # source x 2 n_out
    i0 = num // (2 * n_out)
    t = (num - i0 * 2 * n_out).double() / (2 * n_out)
    return i0, (i0 + 1).clamp(max=n_in - 1), t


def resize(frames_u8: torch.Tensor, res: int) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> float32 (B, res, res, 3) whole pixel values:
    bilinear in float64 over exact taps, rounded half up."""
    x = frames_u8.double()
    for dim in (1, 2):
        i0, i1, t = _taps(x.shape[dim], res, x.device)
        shape = [1, 1, 1, 1]
        shape[dim] = res
        t = t.reshape(shape)
        x = (1 - t) * x.index_select(dim, i0) + t * x.index_select(dim, i1)
    return torch.floor(x + 0.5).clamp(0, 255).float()


def log_probs(p: dict, frames_u8: torch.Tensor, cfg: dict,
              res: int) -> torch.Tensor:
    """(B, grid, grid, n_classes) float32 log-probabilities."""
    with torch.no_grad(), vit.no_tf32():
        x = vit.normalize(resize(frames_u8, res))
        feats = vit.forward(p, "dino.", x, cfg)[:, 1:]
        n = len(cfg["head_dims"]) - 1
        for i in range(n):
            feats = linear(feats, p[f"clf.layer_{i + 1}.weight"],
                           p[f"clf.layer_{i + 1}.bias"])
            if i < n - 1:
                feats = torch.relu(feats)
        grid = res // cfg["patch_size"]
        return feats.log_softmax(dim=-1).reshape(frames_u8.shape[0], grid,
                                                 grid, -1)


def label_maps(logp: torch.Tensor) -> torch.Tensor:
    """(B, g, g, C) -> (B, 480, 480) int64 maps: argmax, each patch over a
    (480 // g)-pixel square."""
    f = 480 // logp.shape[1]
    return logp.argmax(dim=-1).repeat_interleave(f, 1).repeat_interleave(f,
                                                                         2)


# a gap past this is past the reach of bf16's rounding: about 3x the
# largest error scale of the bf16 program's log-probabilities on the card
FAR = 3e-3


def label_counts(logp: torch.Tensor, maps: torch.Tensor) -> dict:
    """The labels of ``maps`` (B, S, S) against ``logp`` (B, g, g, C),
    S = g * (480 // g): at every pixel the gap, the reference's best
    log-probability less that of the map's label.  Counts of pixels:
    ``miss``, a gap over 0 (a label not the reference's best), and
    ``far``, a gap over FAR.  A label out of range, or a map of the wrong
    shape, counts as far."""
    b, g, _, c = logp.shape
    f = 480 // g
    labels = maps.to(logp.device).long()
    if (tuple(maps.shape) != (b, g * f, g * f)
            or bool(((labels < 0) | (labels >= c)).any())):
        return {"miss": 1, "far": 1}
    labels = labels.reshape(b, g, f, g, f).permute(0, 1, 3, 2, 4)
    labels = labels.reshape(b, g, g, f * f)
    gap = (logp.max(dim=-1, keepdim=True).values
           - torch.gather(logp, 3, labels))
    return {"miss": int((gap > 0).sum()), "far": int((gap > FAR).sum())}


def label_far(counts: dict) -> float:
    """``label_far``: of the pixels whose label is not the reference's
    best, the share whose gap is over FAR (0 with none off the best).
    Rounding in a lower precision than the program's flips labels at
    nearer and farther ties alike, so the tail of the off-best gaps grows
    with the error's scale faster than the count of flips or the largest
    gap do."""
    return counts["far"] / counts["miss"] if counts["miss"] else 0.0
