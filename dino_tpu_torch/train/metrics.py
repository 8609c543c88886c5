"""Segmentation metrics from a confusion matrix kept on the device.

The reference concatenates every validation patch on the host and calls
sklearn (balanced_accuracy_score, f1_score(macro), jaccard_score(macro)).
All three are functions of the (C, C) confusion matrix, so the step
accumulates the matrix where the predictions are and the formulas run on the
host in numpy, with sklearn's label selection:

  * balanced accuracy: mean recall over the classes present in y_true
  * macro F1 / macro IoU: mean over the classes present in y_true OR y_pred,
    zero division -> 0
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, gt: torch.Tensor, n_classes: int,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M,) int predictions and labels -> (C, C) int64 counts; rows = true,
    cols = predicted.  ``weights`` (0/1 per element) leaves padded elements
    out.  The counts are scattered with ``index_add_``, which is exact for
    integers and, unlike ``bincount``, needs no host sync on the card."""
    idx = gt.long() * n_classes + pred.long()
    add = (torch.ones_like(idx) if weights is None
           else weights.to(torch.int64))
    flat = torch.zeros(n_classes * n_classes, dtype=torch.int64,
                       device=idx.device)
    return flat.index_add_(0, idx, add).reshape(n_classes, n_classes)


def balanced_accuracy_from_cm(cm: np.ndarray) -> float:
    cm = np.asarray(cm, np.float64)
    support = cm.sum(axis=1)
    present = support > 0
    if not present.any():
        return 0.0
    recall = np.where(present, np.diag(cm) / np.maximum(support, 1), 0.0)
    return float(recall[present].mean())


def _macro_over_union_labels(cm: np.ndarray, score_fn) -> float:
    cm = np.asarray(cm, np.float64)
    true_sum = cm.sum(axis=1)
    pred_sum = cm.sum(axis=0)
    labels = (true_sum > 0) | (pred_sum > 0)
    if not labels.any():
        return 0.0
    scores = score_fn(np.diag(cm), true_sum, pred_sum)
    return float(scores[labels].mean())


def macro_f1_from_cm(cm: np.ndarray) -> float:
    def f1(tp, t, p):
        denom = t + p
        return np.where(denom > 0, 2 * tp / np.maximum(denom, 1e-12), 0.0)
    return _macro_over_union_labels(cm, f1)


def macro_jaccard_from_cm(cm: np.ndarray) -> float:
    def iou(tp, t, p):
        union = t + p - tp
        return np.where(union > 0, tp / np.maximum(union, 1e-12), 0.0)
    return _macro_over_union_labels(cm, iou)


def segmentation_metrics(cm, prefix: str = "val") -> Dict[str, float]:
    cm = np.asarray(cm.cpu() if isinstance(cm, torch.Tensor) else cm)
    return {
        f"{prefix}_acc": balanced_accuracy_from_cm(cm),
        f"{prefix}_F1": macro_f1_from_cm(cm),
        f"{prefix}_iou": macro_jaccard_from_cm(cm),
        # total patches counted: surfaces silently dropped samples
        f"{prefix}_support": float(cm.sum()),
    }


def per_class_metrics_from_cm(cm, class_names=None) -> list:
    """Per-class recall / precision / F1 / IoU / support rows; classes with
    no true or predicted patches report zeros, as the macro functions'
    zero-division rule."""
    cm = np.asarray(cm.cpu() if isinstance(cm, torch.Tensor) else cm,
                    np.float64)
    n = cm.shape[0]
    names = (list(class_names) if class_names is not None
             else [str(i) for i in range(n)])
    tp = np.diag(cm)
    true_sum = cm.sum(axis=1)
    pred_sum = cm.sum(axis=0)
    rows = []
    for c in range(n):
        t, p = true_sum[c], pred_sum[c]
        union = t + p - tp[c]
        rows.append({"class": names[c] if c < len(names) else str(c),
                     "recall": float(tp[c] / t if t > 0 else 0.0),
                     "precision": float(tp[c] / p if p > 0 else 0.0),
                     "f1": float(2 * tp[c] / (t + p) if t + p > 0 else 0.0),
                     "iou": float(tp[c] / union if union > 0 else 0.0),
                     "support": float(t)})
    return rows
