"""Hierarchical classification losses: the port of
``learning_embeddings_tpu/losses/classification.py``.

Conventions as there: ``logits`` (B, n_classes) over all levels
concatenated, ``level_labels`` (B, L) relative per-level integer labels,
scalar batch-mean losses. Only ``make_multi_level_ce`` is ported so far;
the other four criteria follow (ROADMAP.md queue A item 5).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["make_multi_level_ce"]


def _level_slices(labelmap):
    return [
        (int(labelmap.level_start[l]), int(labelmap.level_stop[l]))
        for l in range(labelmap.n_levels)
    ]


def _ce_from_logits(logits, labels, class_weights=None):
    """Per-sample cross entropy −w[y]·log softmax(logits)[y]
    (torch CrossEntropyLoss(weight, reduction='none') semantics)."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    if class_weights is not None:
        nll = nll * class_weights[labels]
    return nll


def make_multi_level_ce(labelmap, level_weights=None, class_weights=None,
                        device="cpu"):
    """Σ_l w_l · CE over each level's logit slice; batch mean. Class
    weights are put on `device` once, here."""
    slices = _level_slices(labelmap)
    lw = (np.ones(labelmap.n_levels) if level_weights is None
          else np.asarray(level_weights))
    cw = (None if class_weights is None else
          torch.as_tensor(np.asarray(class_weights, np.float32),
                          device=device))

    def loss_fn(logits, level_labels):
        total = 0.0
        for l, (a, b) in enumerate(slices):
            w_l = None if cw is None else cw[a:b]
            total = total + float(lw[l]) * _ce_from_logits(
                logits[:, a:b], level_labels[:, l], w_l)
        return total.mean()

    return loss_fn
