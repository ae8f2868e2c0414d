"""Classification metrics: the port of ``prf1_from_counts`` from
``learning_embeddings_tpu/eval/metrics.py`` (lines 66-88). The rest of
that module is ROADMAP.md queue A item 8. Pure numpy."""

from __future__ import annotations

import numpy as np

__all__ = ["prf1_from_counts"]


def prf1_from_counts(tp, pred_count, support, degenerate_one: bool):
    """Guarded per-class precision/recall/F1 from counts.

    degenerate_one: classes with tp == fp == fn == 0 (no support, never
    predicted) score 1.0 (the reference's MetricsMultiLevel convention);
    the joint classification metrics score them 0.0, so callers choose."""
    tp = np.asarray(tp, np.float64)
    pred_count = np.asarray(pred_count, np.float64)
    support = np.asarray(support, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        prec = np.where(pred_count > 0, tp / np.maximum(pred_count, 1e-30),
                        0.0)
        rec = np.where(support > 0, tp / np.maximum(support, 1e-30), 0.0)
        pr = prec + rec
        f1 = np.where(pr > 0, 2 * prec * rec / np.maximum(pr, 1e-30), 0.0)
    if degenerate_one:
        degen = (pred_count == 0) & (support == 0)
        prec = np.where(degen, 1.0, prec)
        rec = np.where(degen, 1.0, rec)
        f1 = np.where(degen, 1.0, f1)
    return prec, rec, f1
