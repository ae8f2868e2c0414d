"""2-d bottleneck-head plots: the port of ``plot_label_vectors`` from
``learning_embeddings_tpu/viz/contours.py`` (lines 87-115), the per-eval
label plot of the ``bottleneck2d`` head. The rest of that module is
ROADMAP.md queue A item 20. matplotlib is imported inside the function.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["plot_label_vectors"]


def plot_label_vectors(level_weights, labelmap, save_path: str,
                       title: str = "") -> None:
    """level_weights: per level, a (2, n_level) or (n_level, 2) weight
    matrix (the bottleneck2d head's per-level weights); one arrow and one
    point per label, coloured by level."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    colors = plt.cm.viridis(np.linspace(0, 0.9, labelmap.n_levels))
    for l, W in enumerate(level_weights):
        W = np.asarray(W)
        if W.shape[0] == 2:
            W = W.T                       # (n, 2)
        for i in range(W.shape[0]):
            ax.annotate("", xy=W[i], xytext=(0, 0),
                        arrowprops=dict(arrowstyle="->", color=colors[l],
                                        alpha=0.7))
        ax.scatter(W[:, 0], W[:, 1], color=colors[l], s=18,
                   label=labelmap.level_names[l])
    ax.set_aspect("equal")
    ax.legend(fontsize=8)
    ax.set_title(title or "2-d label representations")
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight", dpi=130)
    plt.close(fig)
