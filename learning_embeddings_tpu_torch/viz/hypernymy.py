"""Hierarchy-embedding plots for real taxonomies: the port of
``learning_embeddings_tpu/viz/hypernymy.py``. The first two dimensions of
the label embeddings with the tree's edges and, for the top levels, each
node's entailment-cone wedge; the joint trainers' image embeddings
overlaid, coloured by leaf. matplotlib is imported inside the function.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .toy import cone_half_aperture

__all__ = ["plot_hierarchy_embedding"]


def plot_hierarchy_embedding(
    label_emb: np.ndarray,
    labelmap,
    save_path: str,
    *,
    img_emb: Optional[np.ndarray] = None,
    img_leaf_labels: Optional[np.ndarray] = None,
    energy: str = "hyp_cone",
    K: Optional[float] = 0.1,
    wedges_for_levels=(0, 1),
    title: str = "",
) -> None:
    """2-D projection (first two dims) of the label embeddings with the
    tree's edges; cone wedges only for `wedges_for_levels` (hundreds of
    leaf wedges are unreadable)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Wedge

    emb = np.asarray(label_emb)[:, :2]
    lvl = labelmap.level_of_global()
    fig, ax = plt.subplots(figsize=(10, 10))

    if img_emb is not None:
        ie = np.asarray(img_emb)[:, :2]
        c = (np.asarray(img_leaf_labels)
             if img_leaf_labels is not None else "lightgray")
        ax.scatter(ie[:, 0], ie[:, 1], s=4, c=c, cmap="tab20", alpha=0.35,
                   zorder=1, label="images")

    parent = labelmap.parent_ix
    for child in range(labelmap.n_classes):
        p = parent[child]
        if p >= 0:
            ax.plot([emb[p, 0], emb[child, 0]], [emb[p, 1], emb[child, 1]],
                    color="gray", lw=0.3, alpha=0.4, zorder=2)

    colors = plt.cm.viridis(np.linspace(0, 0.9, labelmap.n_levels))
    for l in range(labelmap.n_levels):
        sel = lvl == l
        ax.scatter(emb[sel, 0], emb[sel, 1], s=max(40 - 10 * l, 8),
                   color=colors[l], label=labelmap.level_names[l], zorder=4)

    if energy in ("hyp_cone", "euc_cone") and K is not None:
        norms = np.linalg.norm(emb, axis=1)
        ang = np.degrees(np.arctan2(emb[:, 1], emb[:, 0]))
        half = np.degrees(cone_half_aperture(norms, energy, K))
        for i in range(len(emb)):
            if lvl[i] in wedges_for_levels:
                ax.add_patch(Wedge(emb[i], 0.3 * max(norms.max(), 1e-3),
                                   ang[i] - half[i], ang[i] + half[i],
                                   alpha=0.06, color=colors[lvl[i]],
                                   zorder=3))
        if energy == "hyp_cone":
            ax.add_patch(plt.Circle((0, 0), 1.0, fill=False, ls="--",
                                    color="k", lw=0.8))

    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title(title or f"{energy} hierarchy embedding")
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight", dpi=130)
    plt.close(fig)
