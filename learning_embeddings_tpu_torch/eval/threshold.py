"""Decision-threshold calibration for edge energies: the port of
``learning_embeddings_tpu/eval/threshold.py``.

Classification rule (the reference's ``calculate_best``): positive-pair
energies ``<= t`` are correct positives, negative-pair energies ``> t``
correct negatives. The best-F1 sweep takes every observed energy as a
candidate: a sort and two ``searchsorted(right=True)``, on the device the
energies lie on. Ties in F1 go to the smallest threshold.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["ThresholdMetrics", "best_threshold_metrics", "threshold_metrics"]


class ThresholdMetrics(NamedTuple):
    """0-d f32 tensors."""

    f1: torch.Tensor
    threshold: torch.Tensor
    accuracy: torch.Tensor
    precision: torch.Tensor
    recall: torch.Tensor
    correct_positives: torch.Tensor
    correct_negatives: torch.Tensor


def _flat_f32(e_pos, e_neg):
    e_pos = torch.as_tensor(e_pos).reshape(-1).to(torch.float32)
    e_neg = torch.as_tensor(e_neg, device=e_pos.device).reshape(-1) \
        .to(torch.float32)
    return e_pos, e_neg


def _metrics_at(cp, cn, n_pos, n_neg):
    accuracy = (cp + cn) / (n_pos + n_neg)
    den = cp + (n_neg - cn)
    precision = torch.where(den > 0, cp / torch.clamp_min(den, 1), 0.0)
    recall = cp / max(n_pos, 1)
    pr = precision + recall
    f1 = torch.where(pr > 0, 2.0 * precision * recall
                     / torch.clamp_min(pr, 1e-30), 0.0)
    return f1, accuracy, precision, recall


def best_threshold_metrics(e_pos, e_neg) -> ThresholdMetrics:
    """Exact best-F1 threshold over all candidate energies (duplicates
    share identical metric values, so the arg-max over the sorted array
    equals one over the unique values). Ties go to the smallest
    threshold."""
    e_pos, e_neg = _flat_f32(e_pos, e_neg)
    n_pos, n_neg = e_pos.shape[0], e_neg.shape[0]
    cand = torch.sort(torch.cat([e_pos, e_neg])).values
    cp = torch.searchsorted(torch.sort(e_pos).values, cand,
                            right=True).to(torch.float32)
    below_neg = torch.searchsorted(torch.sort(e_neg).values, cand,
                                   right=True).to(torch.float32)
    cn = n_neg - below_neg
    f1, accuracy, precision, recall = _metrics_at(cp, cn, n_pos, n_neg)
    best = torch.argmax(f1)   # the first maximum: the smallest threshold
    return ThresholdMetrics(f1[best], cand[best], accuracy[best],
                            precision[best], recall[best], cp[best],
                            cn[best])


def threshold_metrics(e_pos, e_neg, threshold) -> ThresholdMetrics:
    """Metrics at a fixed (val-calibrated) threshold."""
    e_pos, e_neg = _flat_f32(e_pos, e_neg)
    n_pos, n_neg = e_pos.shape[0], e_neg.shape[0]
    t = torch.as_tensor(threshold, dtype=torch.float32, device=e_pos.device)
    cp = (e_pos <= t).sum().to(torch.float32)
    cn = (e_neg > t).sum().to(torch.float32)
    f1, accuracy, precision, recall = _metrics_at(cp, cn, n_pos, n_neg)
    return ThresholdMetrics(f1, t, accuracy, precision, recall, cp, cn)
