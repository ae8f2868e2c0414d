"""Hierarchy graph-reconstruction check: the port of
``learning_embeddings_tpu/eval/reconstruction.py``.

All transitive-closure edges of the label subgraph are positives, all other
off-diagonal pairs negatives. The (N, N) energy matrix comes from one
``pairwise_energy`` call (for the order energy, the kernel of
``ops/pairwise_order.py`` on the card) and the threshold sweep from
``eval/threshold.py``, both on the embeddings' device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..geometry import pairwise_energy
from .threshold import (ThresholdMetrics, best_threshold_metrics,
                        threshold_metrics)

__all__ = ["reconstruction_metrics"]


def reconstruction_metrics(
    embeddings,
    closure: np.ndarray,
    energy: str = "hyp_cone",
    threshold: Optional[float] = None,
    **energy_kw,
) -> ThresholdMetrics:
    """F1/acc/P/R of reconstructing `closure` from pairwise energies.

    embeddings: (N, D) label embeddings. closure: (N, N) bool transitive
    closure. With `threshold=None` the best-F1 threshold is swept;
    otherwise the metrics are taken at the fixed threshold."""
    emb = torch.as_tensor(embeddings)
    E = pairwise_energy(energy, emb, emb, **energy_kw)
    closure = torch.as_tensor(np.asarray(closure, dtype=bool),
                              device=E.device)
    offdiag = ~torch.eye(closure.shape[0], dtype=torch.bool,
                         device=E.device)
    e_pos = E[closure]
    e_neg = E[~closure & offdiag]
    if threshold is None:
        return best_threshold_metrics(e_pos, e_neg)
    return threshold_metrics(e_pos, e_neg, threshold)
