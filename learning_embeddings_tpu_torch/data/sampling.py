"""Index samplers: the port of ``learning_embeddings_tpu/data/sampling.py``.

``WeightedResampler`` is the reference's inverse / inverse-sqrt
leaf-frequency ``WeightedRandomSampler`` with replacement: per-sample
probability ∝ 1/count(leaf) or 1/sqrt(count(leaf)), len(dataset) draws an
epoch. Both samplers draw from a numpy ``RandomState``, as the JAX package
does, so a seed gives the same epoch orders there and here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["WeightedResampler", "shuffled_order"]


def shuffled_order(n: int, rng: np.random.RandomState) -> np.ndarray:
    return rng.permutation(n)


class WeightedResampler:
    def __init__(self, leaf_labels: np.ndarray, n_leaf: int,
                 weight_strategy: str = "inv"):
        """weight_strategy ∈ {'inv', 'inv_sqrt'}."""
        counts = np.bincount(leaf_labels, minlength=n_leaf).astype(np.float64)
        counts = np.maximum(counts, 1.0)
        if weight_strategy == "inv":
            w = 1.0 / counts
        elif weight_strategy == "inv_sqrt":
            w = 1.0 / np.sqrt(counts)
        else:
            raise ValueError(f"unknown weight_strategy {weight_strategy!r}")
        per_sample = w[leaf_labels]
        self.probs = per_sample / per_sample.sum()
        self.n = len(leaf_labels)

    def order(self, rng: np.random.RandomState,
              n_draws: Optional[int] = None) -> np.ndarray:
        """Sample with replacement (WeightedRandomSampler semantics)."""
        return rng.choice(self.n, size=n_draws or self.n, replace=True,
                          p=self.probs)
