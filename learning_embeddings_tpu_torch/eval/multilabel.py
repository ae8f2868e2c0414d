"""Multi-label evaluation with per-class threshold tuning: the port of
``learning_embeddings_tpu/eval/multilabel.py`` (lines 34-224).

* per-class PR curves + AP / mAP over sigmoid-style scores,
* per-class decision thresholds tuned on val to maximise F1,
* binary per-class confusion stats at the tuned thresholds; macro = mean
  over the class subset, micro from the summed 2×2 counts,
* the reference's ``accuracy_score`` (the mean prediction where the
  multi-hot is 1, i.e. its recall),
* a single shared threshold over the flattened score matrix.

The JAX module calls sklearn's ``precision_recall_curve`` and
``average_precision_score``; here they are numpy functions with sklearn's
rules (a curve point at the last index of each run of tied scores,
thresholds in increasing order, precision 1 and recall 0 appended, AP as
the step integral clipped at 0), so no machine needs sklearn. matplotlib
is imported inside the two ``render_*`` functions only.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .metrics import prf1_from_counts

__all__ = [
    "precision_recall_curve",
    "average_precision_score",
    "per_class_pr",
    "tune_per_class_thresholds",
    "tune_single_threshold",
    "multilabel_metrics",
    "render_pr_curves",
    "render_score_vs_freq",
]


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds) of a binary problem, as sklearn's
    ``precision_recall_curve`` (drop_intermediate=False) gives them:
    thresholds are the distinct scores in increasing order; precision and
    recall have one more entry, 1 and 0."""
    y_true = np.asarray(y_true).reshape(-1) == 1
    y_score = np.asarray(y_score).reshape(-1)
    desc = np.argsort(y_score, kind="stable")[::-1]
    y_score, y_true = y_score[desc], y_true[desc]
    # one operating point at the end of each run of tied scores
    idx = np.concatenate([np.nonzero(np.diff(y_score))[0],
                          [y_true.size - 1]])
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    ps = tps + fps
    with np.errstate(invalid="ignore", divide="ignore"):
        precision = np.where(ps != 0, tps / ps, 0.0)
    recall = (np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1])
    return (np.concatenate([precision[::-1], [1.0]]),
            np.concatenate([recall[::-1], [0.0]]),
            y_score[idx][::-1])


def _step_ap(precision, recall) -> float:
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def average_precision_score(y_true, y_score) -> float:
    """Step-function AP of a binary problem (sklearn's)."""
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return _step_ap(precision, recall)


def _f1(p, r):
    p, r = np.asarray(p), np.asarray(r)
    return (p * r) * 2 / (p + r + 1e-6)   # reference get_f1score epsilon


def per_class_pr(scores: np.ndarray, multihot: np.ndarray,
                 compute_ap: bool = True):
    """Per-class (precision, recall, thresholds, AP) + mAP. Zero-support
    classes get empty curves and AP 0.0. compute_ap=False skips the AP
    (threshold tuning needs only the curves)."""
    out = {}
    aps = []
    empty = np.array([], np.float64)
    for c in range(scores.shape[1]):
        y = multihot[:, c]
        if y.sum() == 0:
            out[c] = (empty, empty, empty, 0.0)
            aps.append(0.0)
            continue
        p, r, t = precision_recall_curve(y, scores[:, c])
        ap = _step_ap(p, r) if compute_ap else 0.0
        out[c] = (p, r, t, ap)
        aps.append(ap)
    return out, float(np.mean(aps))


def tune_per_class_thresholds(scores: np.ndarray,
                              multihot: np.ndarray) -> np.ndarray:
    """Best-F1 threshold per class from its PR curve (val calibration)."""
    curves, _ = per_class_pr(scores, multihot, compute_ap=False)
    th = np.zeros(scores.shape[1], np.float64)
    for c, (p, r, t, ap) in curves.items():
        if len(t) == 0:
            continue
        best = int(np.argmax(_f1(p, r)))
        th[c] = t[min(best, len(t) - 1)]
    return th


def tune_single_threshold(scores: np.ndarray, multihot: np.ndarray) -> float:
    """One shared threshold over the flattened matrix maximising F1.
    Predicted positive = score >= t."""
    s = scores.reshape(-1)
    y = multihot.reshape(-1) > 0
    order = np.argsort(-s)                       # descending
    s_sorted = s[order]
    tp = np.cumsum(y[order])
    fp = np.cumsum(~y[order])
    # with score >= t a run of tied scores is all-or-nothing: only the
    # last position of each run is an operating point a threshold can make
    last_of_run = np.ones(len(s_sorted), bool)
    last_of_run[:-1] = s_sorted[:-1] != s_sorted[1:]
    tp, fp = tp[last_of_run], fp[last_of_run]
    prec = tp / np.maximum(tp + fp, 1)
    rec = tp / max(y.sum(), 1)
    return float(s_sorted[last_of_run][int(np.argmax(_f1(prec, rec)))])


def _binary_stats(pred: np.ndarray, corr: np.ndarray, idx) -> Dict[str, np.ndarray]:
    p = pred[:, idx].astype(bool)
    c = corr[:, idx].astype(bool)
    return {"tp": (p & c).sum(0).astype(np.float64),
            "fp": (p & ~c).sum(0).astype(np.float64),
            "fn": (~p & c).sum(0).astype(np.float64),
            "tn": (~p & ~c).sum(0).astype(np.float64)}


def multilabel_metrics(scores: np.ndarray, multihot: np.ndarray, thresholds,
                       labelmap) -> Dict[str, object]:
    """Global + per-level metrics at the given threshold(s): a scalar (the
    single-threshold variant) or (n_classes,)."""
    th = np.broadcast_to(np.asarray(thresholds, np.float64),
                         (scores.shape[1],))
    pred = scores >= th[None, :]
    corr = multihot > 0

    def subset(idx, degenerate_one=False):
        # per-level metrics follow MetricsMultiLevel (degenerate classes
        # score 1.0); the global block keeps sklearn's 0.0
        s = _binary_stats(pred, corr, idx)
        prec, rec, f1 = prf1_from_counts(
            s["tp"], s["tp"] + s["fp"], s["tp"] + s["fn"],
            degenerate_one=degenerate_one)
        Tp, Fp, Fn = s["tp"].sum(), s["fp"].sum(), s["fn"].sum()
        micro_p = Tp / max(Tp + Fp, 1)
        micro_r = Tp / max(Tp + Fn, 1)
        micro_f1 = (2 * micro_p * micro_r / (micro_p + micro_r)
                    if micro_p + micro_r > 0 else 0.0)
        mask = corr[:, idx]
        acc = float(pred[:, idx][mask].mean()) if mask.any() else 0.0
        return {
            "macro": {"precision": float(prec.mean()),
                      "recall": float(rec.mean()), "f1": float(f1.mean())},
            "micro": {"precision": float(micro_p), "recall": float(micro_r),
                      "f1": float(micro_f1)},
            "precision": prec, "recall": rec, "f1": f1,
            "tp": s["tp"], "fp": s["fp"], "fn": s["fn"], "tn": s["tn"],
            "accuracy_score": acc,
        }

    out: Dict[str, object] = {"global": subset(np.arange(scores.shape[1]))}
    for l, name in enumerate(labelmap.level_names):
        a, b = int(labelmap.level_start[l]), int(labelmap.level_stop[l])
        out[name] = subset(np.arange(a, b), degenerate_one=True)
    return out


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def render_pr_curves(scores: np.ndarray, multihot: np.ndarray, class_names,
                     out_dir: str, max_classes: int = 32):
    """Precision/recall/F1-vs-threshold plots of the `max_classes`
    highest-support classes; returns (paths written, mAP)."""
    plt = _pyplot()
    os.makedirs(out_dir, exist_ok=True)
    order = np.argsort(-multihot.sum(axis=0))[:max_classes]
    curves, mAP = per_class_pr(scores, multihot)
    written = []
    for c in order:
        p, r, t, ap = curves[int(c)]
        if len(t) == 0:
            continue
        f1 = _f1(p, r)
        fig, ax = plt.subplots()
        ax.plot(t, p[:-1], "b:", label="precision")
        ax.plot(t, r[:-1], "r:", label="recall")
        ax.plot(t, f1[:-1], "g:", label="f1-score")
        ax.set_xlabel("threshold")
        ax.set_ylim([0, 1])
        ax.legend(loc="upper left")
        name = str(class_names[int(c)])
        ax.set_title(f"P/R vs threshold — {name} (AP {ap:.3f})")
        path = os.path.join(out_dir, f"prec_recall_{name}.png")
        fig.savefig(path, bbox_inches="tight", dpi=100)
        plt.close(fig)
        written.append(path)
    return written, mAP


def render_score_vs_freq(per_class_score: np.ndarray, train_freq: np.ndarray,
                         out_path: str, title: str = "F1 vs train frequency"):
    """Score-vs-train-frequency scatter with marginal histograms."""
    plt = _pyplot()
    x = np.asarray(train_freq, float)
    y = np.asarray(per_class_score, float)
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_axes([0.1, 0.1, 0.65, 0.65])
    axx = fig.add_axes([0.1, 0.77, 0.65, 0.18], sharex=ax)
    axy = fig.add_axes([0.77, 0.1, 0.18, 0.65], sharey=ax)
    ax.scatter(x, y, s=10, alpha=0.6)
    axx.hist(x, bins=30)
    axy.hist(y, bins=30, orientation="horizontal")
    axx.tick_params(labelbottom=False)
    axy.tick_params(labelleft=False)
    ax.set_xlabel("train frequency")
    ax.set_ylabel("score")
    axx.set_title(title)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight", dpi=110)
    plt.close(fig)
    return out_path
