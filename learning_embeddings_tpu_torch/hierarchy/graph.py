"""Hierarchy graphs as dense boolean adjacency matrices: the port's copy of
``learning_embeddings_tpu/hierarchy/graph.py`` (lines 37-79), the parts the
joint trainer needs. Pure numpy.

Node ids are global labelmap indices for labels; image nodes (joint
training) get ids ``n_labels + image_index``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["transitive_closure", "label_graph_from_paths"]


def transitive_closure(adj: np.ndarray) -> np.ndarray:
    """Boolean transitive closure (excluding self-loops) of a DAG adjacency,
    by repeated boolean squaring: reach = adj | adj@adj | ..., which
    converges in O(log(depth)) rounds."""
    reach = adj.astype(bool).copy()
    while True:
        # float32 matmul: path counts can exceed 255, so uint8 would wrap
        # and drop reachable edges (a positive f32 sum stays > 0)
        new = reach | (reach.astype(np.float32) @ reach.astype(np.float32)
                       > 0)
        if (new == reach).all():
            return new
        reach = new


def label_graph_from_paths(level_labels: np.ndarray, labelmap) -> np.ndarray:
    """Dense (n_classes, n_classes) direct-edge adjacency from observed
    per-sample level-label paths: an edge level_l → level_{l+1} for every
    sample. `level_labels`: (N, n_levels) relative labels per sample; only
    edges seen in the data are added."""
    level_labels = np.asarray(level_labels)
    n = labelmap.n_classes
    A = np.zeros((n, n), dtype=bool)
    glob = level_labels + labelmap.level_start[None, :]
    for l in range(labelmap.n_levels - 1):
        A[glob[:, l], glob[:, l + 1]] = True
    return A
