"""2-d bottleneck-head analysis: the port of
``learning_embeddings_tpu/viz/contours.py``. Each level's weight vectors
of the bias-free per-level linears (the per-eval plot of the
``bottleneck2d`` head), their sphere inversion, which the joint CLIs'
``--load_cosine_emb`` reads as a warm start, the dot-product "Voronoi"
decision regions over the 2-d feature plane, and the label vectors scored
as dot-product order embeddings against the taxonomy. matplotlib is
imported inside the plotting functions.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["plot_label_vectors", "plot_dot_product_voronoi",
           "invert_embeddings", "plot_inverted_embedding",
           "dot_product_reconstruction"]


def invert_embeddings(P: np.ndarray, scale: float = 3.0) -> np.ndarray:
    """Sphere inversion x → scale·max‖x‖·x/‖x‖²: dot-product label
    embeddings grow in norm with specificity, so the inversion turns the
    plot inside out (general concepts outward, specific leaves near the
    origin) and shows the hierarchy's radial structure."""
    P = np.asarray(P, np.float64)
    norms = np.linalg.norm(P, axis=1, keepdims=True)
    norms = np.maximum(norms, 1e-12)
    return (scale * norms.max()) * P / (norms ** 2)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, plt, save_path: str) -> None:
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight", dpi=130)
    plt.close(fig)


def plot_inverted_embedding(label_vectors: np.ndarray, labelmap,
                            save_path: str, title: str = "") -> np.ndarray:
    """Inverted 2-d label embedding with the taxonomy's edges overlaid.
    label_vectors: (n_classes, 2) global per-node vectors (the per-level
    head weights concatenated in global index order). Returns the
    inverted points."""
    plt = _pyplot()
    inv = invert_embeddings(label_vectors)
    fig, ax = plt.subplots(figsize=(8, 7))
    colors = plt.cm.viridis(np.linspace(0, 0.9, labelmap.n_levels))
    level_of = labelmap.level_of_global()
    parent = labelmap.parent_ix
    for child in range(labelmap.n_classes):   # parent → child edges
        p = parent[child]
        if p >= 0:
            ax.plot([inv[p, 0], inv[child, 0]], [inv[p, 1], inv[child, 1]],
                    "b-", alpha=0.2, lw=0.7)
    for l in range(labelmap.n_levels):
        pts = inv[level_of == l]
        ax.scatter(pts[:, 0], pts[:, 1], color=colors[l], s=14,
                   label=labelmap.level_names[l])
    ax.set_aspect("equal")
    ax.legend(fontsize=8)
    ax.set_title(title or "inverted 2-d label embedding")
    _save(fig, plt, save_path)
    return inv


def dot_product_reconstruction(label_vectors: np.ndarray, labelmap):
    """The 2-d head's label vectors scored as dot-product order embeddings
    against the taxonomy's closure: energy −⟨u, v⟩, so that related pairs
    (high dot) have LOW energy, as the threshold sweep's pos ≤ t rule
    wants. Returns the best-F1 ``ThresholdMetrics``."""
    from ..eval.threshold import best_threshold_metrics
    from ..hierarchy.graph import transitive_closure

    P = np.asarray(label_vectors, np.float32)
    closure = transitive_closure(labelmap.full_child_mask())
    E = -(P @ P.T)
    offdiag = ~np.eye(len(P), dtype=bool)
    return best_threshold_metrics(E[closure & offdiag],
                                  E[(~closure) & offdiag])


def plot_label_vectors(level_weights, labelmap, save_path: str,
                       title: str = "") -> None:
    """level_weights: per level, a (2, n_level) or (n_level, 2) weight
    matrix (the bottleneck2d head's per-level weights); one arrow and one
    point per label, coloured by level."""
    plt = _pyplot()
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
    _save(fig, plt, save_path)


def plot_dot_product_voronoi(W: np.ndarray, save_path: str,
                             extent: float = 3.0, res: int = 400,
                             title: str = "") -> np.ndarray:
    """argmax_i ⟨w_i, z⟩ over a grid of 2-d features z: the dot-product
    Voronoi regions of one level's classes. W: (2, n) or (n, 2). Returns
    the (res, res) region map."""
    plt = _pyplot()
    W = np.asarray(W)
    if W.shape[0] == 2:
        W = W.T
    xs = np.linspace(-extent, extent, res)
    X, Y = np.meshgrid(xs, xs)
    Z = np.stack([X.ravel(), Y.ravel()], axis=1)      # (res², 2)
    region = np.argmax(Z @ W.T, axis=1).reshape(res, res)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(region, origin="lower",
              extent=[-extent, extent, -extent, extent], cmap="tab20",
              alpha=0.6)
    ax.scatter(W[:, 0], W[:, 1], color="k", s=20)
    ax.set_title(title or "dot-product Voronoi")
    _save(fig, plt, save_path)
    return region
