"""Hierarchy graphs as dense boolean adjacency matrices: the port's copy of
``learning_embeddings_tpu/hierarchy/graph.py``. Pure numpy, the same
``RandomState`` protocol for the edge splits, so the same seed gives the
same splits.

Node ids are global labelmap indices for labels; image nodes (joint
training) get ids ``n_labels + image_index``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["transitive_closure", "negative_adjacency",
           "label_graph_from_paths", "EdgeSplits", "split_edges",
           "edges_from_adjacency"]


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


def negative_adjacency(closure: np.ndarray) -> np.ndarray:
    """All-ones minus the closure edges minus the diagonal: True where
    (u, v) is a negative (non-entailed) pair."""
    A = ~closure.astype(bool)
    np.fill_diagonal(A, False)
    return A


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


@dataclasses.dataclass
class EdgeSplits:
    """Edge-level train/val/test splits over a transitive closure.

    ``train`` holds the basic (direct) edges plus a proportion of the
    non-basic (transitive-only) edges; ``val`` and ``test`` each hold a
    disjoint fraction of the non-basic edges. Each is an (E, 2) int32 array
    of (u, v) global node ids."""

    train: np.ndarray
    val: np.ndarray
    test: np.ndarray
    closure: np.ndarray          # (n, n) bool transitive closure
    negatives: np.ndarray        # (n, n) bool negative adjacency


def edges_from_adjacency(adj: np.ndarray) -> np.ndarray:
    """(E, 2) int32 edge list in row-major (u, then v) order."""
    u, v = np.nonzero(adj)
    return np.stack([u, v], axis=1).astype(np.int32)


def split_edges(basic_adj: np.ndarray, *,
                proportion_of_nb_edges_in_train: float = 0.0,
                val_frac: float = 0.05, test_frac: float = 0.05,
                seed: int = 0) -> EdgeSplits:
    """All basic edges go to train; of the non-basic (closure-only) edges,
    `val_frac` go to val and `test_frac` to test (disjoint, by one
    ``RandomState(seed)`` permutation), and
    `proportion_of_nb_edges_in_train` of all of them, taken from the
    remainder, to train."""
    closure = transitive_closure(basic_adj)
    negatives = negative_adjacency(closure)

    nb_edges = edges_from_adjacency(closure & ~basic_adj.astype(bool))
    n_nb = len(nb_edges)

    perm = np.random.RandomState(seed).permutation(n_nb)
    n_val = int(val_frac * n_nb)
    n_test = int(test_frac * n_nb)
    val_ix = perm[:n_val]
    test_ix = perm[n_val:n_val + n_test]
    rest_ix = perm[n_val + n_test:]
    train_extra_ix = rest_ix[:int(proportion_of_nb_edges_in_train * n_nb)]

    train = np.concatenate(
        [edges_from_adjacency(basic_adj), nb_edges[train_extra_ix]], axis=0)
    return EdgeSplits(train=train.astype(np.int32),
                      val=nb_edges[val_ix].astype(np.int32),
                      test=nb_edges[test_ix].astype(np.int32),
                      closure=closure, negatives=negatives)
