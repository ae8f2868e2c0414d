"""2-D embedding plots for toy and label hierarchies: the port of
``learning_embeddings_tpu/viz/toy.py``. Scatters the 2-D label embeddings,
draws the tree edges and, for the cone energies, each node's
entailment-cone wedge of half-aperture ψ(x). matplotlib is imported inside
``plot_toy_embedding``, so importing the module needs none."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..geometry import inner_radius

__all__ = ["plot_toy_embedding", "cone_half_aperture"]


def cone_half_aperture(norms: np.ndarray, energy: str, K: float) -> np.ndarray:
    """ψ(x) in radians (hyp: asin(K(1−‖x‖²)/‖x‖); euc: asin(K/‖x‖))."""
    norms = np.maximum(norms, 1e-6)
    if energy == "hyp_cone":
        return np.arcsin(np.clip(K * (1 - norms**2) / norms, -1 + 1e-5, 1 - 1e-5))
    return np.arcsin(np.clip(K / norms, -1 + 1e-5, 1 - 1e-5))


def plot_toy_embedding(embeddings: np.ndarray, labelmap, save_path: str,
                       energy: str = "hyp_cone", K: Optional[float] = 0.1,
                       title: str = "") -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Wedge

    emb = np.asarray(embeddings)[:, :2]
    fig, ax = plt.subplots(figsize=(8, 8))

    # tree edges
    parent = labelmap.parent_ix
    for child in range(labelmap.n_classes):
        p = parent[child]
        if p >= 0:
            ax.plot([emb[p, 0], emb[child, 0]], [emb[p, 1], emb[child, 1]],
                    color="gray", lw=0.5, alpha=0.6, zorder=1)

    # per-level colors
    colors = plt.cm.viridis(np.linspace(0, 0.9, labelmap.n_levels))
    lvl = labelmap.level_of_global()
    for l in range(labelmap.n_levels):
        sel = lvl == l
        ax.scatter(emb[sel, 0], emb[sel, 1], s=30, color=colors[l],
                   label=f"level {l}", zorder=3)

    # cone wedges
    if energy in ("hyp_cone", "euc_cone") and K is not None:
        norms = np.linalg.norm(emb, axis=1)
        ang = np.degrees(np.arctan2(emb[:, 1], emb[:, 0]))
        half = np.degrees(cone_half_aperture(norms, energy, K))
        for i in range(len(emb)):
            ax.add_patch(Wedge(emb[i], 0.25 * max(norms.max(), 1e-3),
                               ang[i] - half[i], ang[i] + half[i],
                               alpha=0.08, color=colors[lvl[i]], zorder=2))
        if energy == "hyp_cone":
            circle = plt.Circle((0, 0), 1.0, fill=False, ls="--", color="k",
                                lw=0.8)
            ax.add_patch(circle)
            ax.add_patch(plt.Circle((0, 0), inner_radius(K), fill=False,
                                    ls=":", color="k", lw=0.6))

    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title(title or f"{energy} embedding")
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight", dpi=130)
    plt.close(fig)
