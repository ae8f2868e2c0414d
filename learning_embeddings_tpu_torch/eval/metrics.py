"""Per-level and global classification metrics: the port of
``learning_embeddings_tpu/eval/metrics.py`` (lines 33-178), in numpy.

Per-level argmax predictions → a confusion matrix per level → per-class
and macro/micro precision, recall, F1 and accuracy (the reference's
``MetricsMultiLevel``/``MultiLevelEvaluation``). Micro scores of a
single-label level equal its accuracy; macro scores average per-class
values, with 1.0 for a class that has neither support nor predictions.
The JAX package builds the confusion matrix from a one-hot matmul on the
device; here it is a ``bincount`` on the host, which counts the same.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

__all__ = [
    "LevelMetrics",
    "confusion_matrix",
    "level_metrics_from_confusion",
    "multilevel_metrics",
    "hierarchical_match_counts",
    "prf1_from_counts",
]


@dataclasses.dataclass
class LevelMetrics:
    accuracy: float
    precision_macro: float
    recall_macro: float
    f1_macro: float
    precision_micro: float
    recall_micro: float
    f1_micro: float
    per_class_precision: np.ndarray
    per_class_recall: np.ndarray
    per_class_f1: np.ndarray
    support: np.ndarray

    def scalars(self) -> Dict[str, float]:
        return {
            "accuracy": self.accuracy,
            "precision_macro": self.precision_macro,
            "recall_macro": self.recall_macro,
            "f1_macro": self.f1_macro,
            "precision_micro": self.precision_micro,
            "recall_micro": self.recall_micro,
            "f1_micro": self.f1_micro,
        }


def confusion_matrix(pred, gt, n_classes: int) -> np.ndarray:
    """(n_classes, n_classes) counts, rows = gt, cols = pred, in float32
    as the JAX package's one-hot matmul gives them (exact below 2**24;
    the pooled micro scores are then computed in the same precision)."""
    pred = np.asarray(pred, np.int64).reshape(-1)
    gt = np.asarray(gt, np.int64).reshape(-1)
    counts = np.bincount(gt * n_classes + pred,
                         minlength=n_classes * n_classes)
    return counts.reshape(n_classes, n_classes).astype(np.float32)


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


def level_metrics_from_confusion(cm: np.ndarray) -> LevelMetrics:
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    support = cm.sum(axis=1)          # gt counts
    pred_count = cm.sum(axis=0)
    total = cm.sum()
    prec, rec, f1 = prf1_from_counts(tp, pred_count, support,
                                     degenerate_one=True)
    acc = float(tp.sum() / max(total, 1.0))
    return LevelMetrics(
        accuracy=acc,
        precision_macro=float(prec.mean()) if len(prec) else 0.0,
        recall_macro=float(rec.mean()) if len(rec) else 0.0,
        f1_macro=float(f1.mean()) if len(f1) else 0.0,
        precision_micro=acc,
        recall_micro=acc,
        f1_micro=acc,
        per_class_precision=prec,
        per_class_recall=rec,
        per_class_f1=f1,
        support=support,
    )


def multilevel_metrics(
    scores: np.ndarray,
    level_labels: np.ndarray,
    labelmap,
    predictions: Optional[np.ndarray] = None,
) -> Dict[str, object]:
    """Per-level argmax over each level's score slice → LevelMetrics per
    level + global (all levels pooled) macro/micro scores.

    scores: (N, n_classes). predictions ((N, L) relative) overrides the
    argmax where given."""
    scores = np.asarray(scores)
    level_labels = np.asarray(level_labels)
    out: Dict[str, object] = {"levels": []}
    cms = []
    for l in range(labelmap.n_levels):
        a, b = int(labelmap.level_start[l]), int(labelmap.level_stop[l])
        pred = (predictions[:, l] if predictions is not None
                else np.argmax(scores[:, a:b], axis=1))
        cm = confusion_matrix(pred, level_labels[:, l], b - a)
        cms.append(cm)
        out["levels"].append(level_metrics_from_confusion(cm))
    # global scores: per-class stats pooled over every level's classes
    tp = np.concatenate([np.diag(c) for c in cms])
    sup = np.concatenate([c.sum(1) for c in cms])
    pc = np.concatenate([c.sum(0) for c in cms])
    prec, rec, f1 = prf1_from_counts(tp, pc, sup, degenerate_one=True)
    out["macro"] = {
        "precision": float(prec.mean()),
        "recall": float(rec.mean()),
        "f1": float(f1.mean()),
    }
    micro_p = float(tp.sum() / max(pc.sum(), 1.0))
    micro_r = float(tp.sum() / max(sup.sum(), 1.0))
    out["micro"] = {
        "precision": micro_p,
        "recall": micro_r,
        "f1": (2 * micro_p * micro_r / (micro_p + micro_r)
               if micro_p + micro_r > 0 else 0.0),
    }
    return out


def hierarchical_match_counts(scores: np.ndarray, level_labels: np.ndarray,
                              labelmap):
    """Exact-match (all levels correct) and per-level match counts."""
    scores = np.asarray(scores)
    level_labels = np.asarray(level_labels)
    matches = []
    for l in range(labelmap.n_levels):
        a, b = int(labelmap.level_start[l]), int(labelmap.level_stop[l])
        matches.append(np.argmax(scores[:, a:b], axis=1) == level_labels[:, l])
    matches = np.stack(matches, axis=1)
    return {
        "exact_match": int(matches.all(axis=1).sum()),
        "per_level_match": matches.sum(axis=0).astype(int).tolist(),
        "n": len(matches),
    }
