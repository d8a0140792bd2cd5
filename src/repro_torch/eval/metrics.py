"""Precision/recall of cache-hit decisions (paper §4.2.1; counterpart of
``src/repro/eval/metrics.py``, numpy only)."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def precision_recall(hits: np.ndarray, labels: np.ndarray) -> Tuple[float, float]:
    """hits: bool (query produced a cache hit); labels: bool (true duplicate).

    TP = hit & duplicate; FP = hit & ~duplicate; FN = ~hit & duplicate.
    """
    tp = float(np.sum(hits & labels))
    fp = float(np.sum(hits & ~labels))
    fn = float(np.sum(~hits & labels))
    precision = tp / max(tp + fp, 1e-9)
    recall = tp / max(tp + fn, 1e-9)
    return precision, recall


def pr_curve(scores: np.ndarray, labels: np.ndarray,
             thresholds: np.ndarray) -> List[dict]:
    out = []
    for t in thresholds:
        p, r = precision_recall(scores >= t, labels)
        out.append({"threshold": float(t), "precision": p, "recall": r,
                    "hit_rate": float(np.mean(scores >= t))})
    return out
