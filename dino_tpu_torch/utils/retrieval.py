"""Feature post-processing and retrieval evaluation: the port of
``dino_tpu/utils/retrieval.py`` (the reference's PCA, compute_ap,
compute_map and multi_scale).

PCA whitening, AP and mAP are host numpy, copied from ``dino_tpu``: the
revisited-Oxford evaluation code the reference carries.  ``multi_scale``
averages L2-normalized features over image scales, resizing with
PyTorch's antialiased bilinear (a triangle filter widened by the
downscale, as ``jax.image.resize``'s bilinear) on the images' device.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F


class PCA:
    """PCA with optional whitening. fit on (N, D) -> apply projects to dim."""

    def __init__(self, dim: int = 256, whit: float = 0.5):
        self.dim = dim
        self.whit = whit
        self.mean: Optional[np.ndarray] = None
        self.dvt: Optional[np.ndarray] = None

    def train_pca(self, cov: np.ndarray) -> None:
        """Fit from a covariance matrix (reference keeps this entry point)."""
        d, v = np.linalg.eigh(cov.astype(np.float64))
        eps = d.max() * 1e-5
        n_0 = (d < eps).sum()
        if n_0 > 0:
            d[d < eps] = eps
        # total energy kept (informational in the reference)
        idx = np.argsort(d)[::-1][:self.dim]
        d = d[idx]
        v = v[:, idx]
        # whitened projection: D^{-whit} V^T
        self.dvt = (np.diag(1.0 / d ** self.whit) @ v.T).astype(np.float32)

    def fit(self, x: np.ndarray) -> "PCA":
        x = np.asarray(x, np.float64)
        self.mean = x.mean(axis=0).astype(np.float32)
        cov = np.cov(x.T)
        self.train_pca(cov)
        return self

    def apply(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if self.mean is not None:
            x = x - self.mean
        return x @ self.dvt.T


def compute_ap(ranks: np.ndarray, nres: int) -> float:
    """Average precision with trapezoidal interpolation, vectorized.

    ``ranks``: sorted zero-based positions of the relevant items in the
    ranked (junk-adjusted) list; ``nres``: total number of relevant items.
    Each hit contributes the average of the precision just before and just
    after retrieving it, weighted by one recall step (1/nres) — the
    revisited-Oxford protocol the reference evaluates with (utils.py:715-746).
    """
    pos = np.asarray(ranks, np.float64)
    if pos.size == 0:
        return 0.0
    hits = np.arange(1.0, pos.size + 1.0)
    prec_after = hits / (pos + 1.0)
    # precision before the hit: (hits-1)/pos, defined as 1 at the very top
    prec_before = np.where(pos > 0, (hits - 1.0) / np.maximum(pos, 1.0), 1.0)
    return float(np.sum(prec_before + prec_after) / (2.0 * nres))


def compute_map(ranks: np.ndarray, gnd: List[dict], kappas: List[int] = ()):
    """mAP + precision@k over a ranked retrieval matrix.

    ranks: (n_db, n_query) ranked db indices per query; gnd[i] holds 'ok'
    (positives) and optional 'junk' indices (ignored entries, removed from
    the ranking before scoring).  Returns (map, aps, pr, prs); queries with
    empty ground truth get NaN rows and are excluded from the means.
    """
    n_query = len(gnd)
    kappas = list(kappas)
    aps = np.full(n_query, np.nan)
    prs = np.full((n_query, len(kappas)), np.nan)

    for i, entry in enumerate(gnd):
        ok = np.asarray(entry["ok"]).ravel()
        if ok.size == 0:
            continue
        column = np.asarray(ranks)[:, i]
        pos = np.flatnonzero(np.isin(column, ok))
        junk = np.asarray(entry.get("junk", ())).ravel()
        if junk.size:
            # re-rank among non-junk results: each positive slides up by the
            # number of junk entries ranked above it
            pos = pos - np.searchsorted(np.flatnonzero(np.isin(column, junk)),
                                        pos)
        aps[i] = compute_ap(pos, ok.size)
        if pos.size:
            # reference (utils.py:795-797) works 1-based: kq = min(max(pos),
            # kappa) with pos >= 1, so the cutoff is never 0.  0-based
            # equivalent: min(pos.max()+1, kappa), count pos < cutoff.
            cutoffs = np.minimum(pos.max() + 1, np.asarray(kappas, np.int64))
            prs[i] = [np.count_nonzero(pos < c) / c if c > 0 else 0.0
                      for c in cutoffs]
        else:
            prs[i] = 0.0

    valid = ~np.isnan(aps)
    if not valid.any():
        return 0.0, aps, np.zeros(len(kappas)), prs
    mean_ap = float(aps[valid].mean())
    pr = (prs[valid].mean(axis=0) if len(kappas)
          else np.zeros(0))
    return mean_ap, aps, pr, prs


def multi_scale(samples: torch.Tensor, forward_fn,
                scales=(1.0, 2 ** -0.5, 0.5)) -> torch.Tensor:
    """Average of L2-normalized features over image scales.

    ``samples`` (B, H, W, C) float tensor; ``forward_fn(batch) -> (B, D)``.
    Each scale's size is floored to a multiple of 8."""
    v = None
    for s in scales:
        if s == 1.0:
            inp = samples
        else:
            b, h, w, c = samples.shape
            nh, nw = int(h * s), int(w * s)
            nh -= nh % 8
            nw -= nw % 8
            inp = F.interpolate(samples.permute(0, 3, 1, 2), size=(nh, nw),
                                mode="bilinear", align_corners=False,
                                antialias=True).permute(0, 2, 3, 1)
        feats = forward_fn(inp).float()
        feats = feats / (torch.linalg.vector_norm(feats, dim=-1,
                                                  keepdim=True) + 1e-12)
        v = feats if v is None else v + feats
    v = v / len(scales)
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)
