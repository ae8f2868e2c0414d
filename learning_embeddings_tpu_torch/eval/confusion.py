"""Cross-level confusion matrices: the port's copy of
``learning_embeddings_tpu/eval/confusion.py`` (numpy; matplotlib imported
only by the plot). The reference's `post_process.plot`
(network/post_process.py:16-117): from dumped predicted scores + correct
labels, confusion between the argmax prediction at level x and the gt at
level y, with child-sorted orderings."""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

__all__ = ["cross_level_confusion", "plot_cross_level_confusion",
           "child_sorted_order"]


def child_sorted_order(labelmap, level_id: int) -> np.ndarray:
    """Relative indices of level `level_id` ordered so that siblings (same
    parent chain) are adjacent — the reference sorts columns child-first
    for readable block structure (post_process.py:40-70)."""
    if level_id == 0:
        return np.arange(labelmap.levels[0])
    order = []

    def walk(parent_rel, l):
        if l == level_id:
            order.append(parent_rel)
            return
        for child in labelmap.get_children_of(parent_rel, l + 1):
            walk(child, l + 1)

    for root in range(labelmap.levels[0]):
        walk(root, 0)
    return np.asarray(order, np.int32)


def cross_level_confusion(
    scores: np.ndarray,
    level_labels: np.ndarray,
    labelmap,
    pred_level: int,
    gt_level: int,
    child_sorted: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(matrix, row_order, col_order): counts of (gt at `gt_level`, argmax
    prediction at `pred_level`)."""
    a, b = int(labelmap.level_start[pred_level]), int(labelmap.level_stop[pred_level])
    pred = np.argmax(scores[:, a:b], axis=1)
    gt = level_labels[:, gt_level]
    m = np.zeros((labelmap.levels[gt_level], labelmap.levels[pred_level]),
                 np.int64)
    np.add.at(m, (gt, pred), 1)
    row_order = (child_sorted_order(labelmap, gt_level)
                 if child_sorted else np.arange(m.shape[0]))
    col_order = (child_sorted_order(labelmap, pred_level)
                 if child_sorted else np.arange(m.shape[1]))
    return m[np.ix_(row_order, col_order)], row_order, col_order


def plot_cross_level_confusion(matrix: np.ndarray, save_path: str,
                               title: str = "") -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 8))
    im = ax.imshow(matrix, cmap="viridis", aspect="auto")
    ax.set_title(title)
    ax.set_xlabel("predicted")
    ax.set_ylabel("ground truth")
    fig.colorbar(im)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
