"""Evaluation component metrics (port of flashe_tpu/nn/evaluation.py, numpy
only; the port keeps its own copy).

The analogue of FATE's Evaluation module (federatedml/evaluation/, wired
into DSL pipelines after the training component): given prediction scores
and true labels it computes the classification metric suite.  Binary
metrics follow the reference surface (auc / ks / accuracy / precision /
recall); multiclass reports accuracy and macro precision/recall/F1.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["evaluate_classification", "binary_auc", "binary_ks"]


def binary_auc(y_true: np.ndarray, scores: np.ndarray) -> float:
    """ROC AUC via the Mann-Whitney U statistic (ties averaged)."""
    y_true = np.asarray(y_true).astype(bool)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos = int(y_true.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    r_pos = ranks[y_true].sum()
    return float((r_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def binary_ks(y_true: np.ndarray, scores: np.ndarray) -> float:
    """Kolmogorov-Smirnov statistic: max |TPR - FPR| over thresholds."""
    y_true = np.asarray(y_true).astype(bool)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos = int(y_true.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(-scores, kind="mergesort")
    tp = np.cumsum(y_true[order])
    fp = np.cumsum(~y_true[order])
    return float(np.max(np.abs(tp / n_pos - fp / n_neg)))


def evaluate_classification(y_true: np.ndarray,
                            scores: np.ndarray) -> Dict[str, float]:
    """Metric suite from (n,) labels and (n, n_classes) or (n,) scores."""
    y_true = np.asarray(y_true).reshape(-1).astype(np.int64)
    scores = np.asarray(scores)
    if scores.ndim == 1:
        scores = np.stack([1.0 - scores, scores], axis=-1)
    if scores.ndim > 2:  # sequence logits: flatten positions
        scores = scores.reshape(-1, scores.shape[-1])
    y_pred = scores.argmax(axis=-1)
    n = len(y_true)
    out: Dict[str, float] = {
        "accuracy": float((y_pred == y_true).mean()) if n else float("nan"),
    }
    n_classes = scores.shape[-1]
    if n_classes == 2:
        out["auc"] = binary_auc(y_true, scores[:, 1])
        out["ks"] = binary_ks(y_true, scores[:, 1])
        tp = int(((y_pred == 1) & (y_true == 1)).sum())
        fp = int(((y_pred == 1) & (y_true == 0)).sum())
        fn = int(((y_pred == 0) & (y_true == 1)).sum())
        out["precision"] = tp / (tp + fp) if tp + fp else float("nan")
        out["recall"] = tp / (tp + fn) if tp + fn else float("nan")
    else:
        precisions, recalls = [], []
        for c in np.unique(y_true):
            tp = int(((y_pred == c) & (y_true == c)).sum())
            fp = int(((y_pred == c) & (y_true != c)).sum())
            fn = int(((y_pred != c) & (y_true == c)).sum())
            if tp + fp:
                precisions.append(tp / (tp + fp))
            if tp + fn:
                recalls.append(tp / (tp + fn))
        out["macro_precision"] = (float(np.mean(precisions))
                                  if precisions else float("nan"))
        out["macro_recall"] = (float(np.mean(recalls))
                               if recalls else float("nan"))
        p, r = out["macro_precision"], out["macro_recall"]
        out["macro_f1"] = (2 * p * r / (p + r)
                           if np.isfinite(p) and np.isfinite(r) and p + r
                           else float("nan"))
    return out
