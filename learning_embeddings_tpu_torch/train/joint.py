"""Shared pieces of the joint image + label trainers: the port of
``learning_embeddings_tpu/train/joint.py`` (lines 49-166).

Node ids: labels are global labelmap indices, train images
``n_labels + row``. The fc7 ``JointEmbeddingTrainer`` and ``FeatNet`` are
not ported yet (ROADMAP.md queue A item 15); the ``--use_CNN`` trainer is
``train/joint_cnn.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..eval import best_threshold_metrics, threshold_metrics
from ..geometry import ENERGY_FNS, inner_radius
from ..losses.joint_sampling import JointGraph, sample_joint_negatives_np

__all__ = ["JOINT_MODE", "DEFAULT_K", "DEFAULT_CURRICULUM",
           "epoch_edge_order", "curriculum_levels_for_epoch",
           "load_label_table", "joint_edge_metrics"]

JOINT_MODE = {"order": "euclidean", "euc_cone": "euc_cone",
              "hyp_cone": "hyp_cone_exp0"}
DEFAULT_K = {"order": None, "euc_cone": 3.0, "hyp_cone": 0.1}
# the reference's curriculum of hidden levels, by starting epoch
DEFAULT_CURRICULUM = {0: (1, 2, 3), 20: (2, 3), 50: (3,), 100: ()}


def epoch_edge_order(graph: JointGraph, edges: np.ndarray,
                     rng: np.random.RandomState,
                     half_half: bool) -> np.ndarray:
    """Shuffle; with half_half, resample to 50% (label, label) and 50%
    (label, image) edges."""
    nl = graph.n_labels
    if half_half:
        is_img = edges[:, 1] >= nl
        img_edges = edges[is_img]
        lab_edges = edges[~is_img]
        n = max(len(img_edges), len(lab_edges))
        if len(img_edges) and len(lab_edges):
            take = lambda arr: arr[rng.randint(0, len(arr), n)]
            edges = np.concatenate([take(img_edges), take(lab_edges)])
    return edges[rng.permutation(len(edges))]


def curriculum_levels_for_epoch(curriculum: Dict[int, Tuple[int, ...]],
                                epoch: int) -> Tuple[int, ...]:
    """Hidden levels active at `epoch` (the latest stage whose start is at
    or before it)."""
    current: Tuple[int, ...] = ()
    for start in sorted(curriculum):
        if epoch >= start:
            current = tuple(curriculum[start])
    return current


def load_label_table(params, table: np.ndarray, energy: str,
                     K: Optional[float]) -> None:
    """Warm-start a label-embedding table from an external one, in place:
    `table` must match the shape of exactly one tensor of `params` (an
    iterable of parameters), else this raises. Under ``hyp_cone`` a table
    not already in the Poincaré annulus [r0, 1) (a 2-D cosine embedding,
    say) is first rescaled into it: row norms map linearly onto
    r0 + (1 − 2·r0)·‖x‖ / max‖x‖."""
    table = np.asarray(table, np.float32)
    if energy == "hyp_cone":
        r0 = inner_radius(K)
        norms = np.linalg.norm(table, axis=1, keepdims=True)
        if norms.max() >= 1.0 or norms.min() < r0:
            norms = np.maximum(norms, 1e-12)
            target = r0 + (1 - 2 * r0) * norms / norms.max()
            table = table / norms * target
    table = torch.as_tensor(table)
    hits = [p for p in params if tuple(p.shape) == tuple(table.shape)]
    if len(hits) != 1:
        raise ValueError(
            f"warm-start table shape {tuple(table.shape)} matched "
            f"{len(hits)} label-embedding params (expected exactly 1)")
    with torch.no_grad():
        hits[0].copy_(table)


def joint_edge_metrics(label_emb, image_emb, img_paths_global, graph,
                       *, energy: str, neg_to_pos_ratio: int,
                       pick_per_level: bool, seed: int,
                       threshold=None, **energy_kw):
    """Edge-classification F1 on a held-out split: positives are every
    (ancestor label → image) edge of the split's images; negatives are
    2·ratio corrupted pairs per positive, drawn on the host from
    RandomState(seed) with empty_image_complement='widen'.

    label_emb: (n_labels, d); image_emb: (n_split_images, d), tensors or
    arrays (moved to the labels' device). threshold=None sweeps the best
    F1 (val); a float reuses it (test)."""
    paths = np.asarray(img_paths_global, np.int32)
    nl = graph.n_labels
    split_graph = JointGraph(
        label_closure=graph.label_closure,
        image_paths_global=paths,
        level_start=graph.level_start,
        level_stop=graph.level_stop)
    n_img, L = paths.shape
    pos_from = paths.reshape(-1)
    pos_to = (nl + np.repeat(np.arange(n_img), L)).astype(np.int32)
    rng = np.random.RandomState(seed)
    # widen: a label covering every image of a small split must yield a
    # metric, not fail an eval
    neg_from, neg_to = sample_joint_negatives_np(
        split_graph, neg_to_pos_ratio, rng, pos_from, pos_to,
        pick_per_level=pick_per_level, empty_image_complement="widen")

    lab = torch.as_tensor(label_emb)
    img = torch.as_tensor(image_emb, device=lab.device)

    def emb(ids):
        ids = torch.as_tensor(ids, dtype=torch.int64, device=lab.device)
        lab_e = lab[torch.clamp_max(ids, nl - 1)]
        img_e = img[torch.clamp_min(ids - nl, 0)]
        return torch.where((ids >= nl)[:, None], img_e, lab_e)

    efn = ENERGY_FNS[energy]
    e_pos = efn(emb(pos_from), emb(pos_to), **energy_kw)
    e_neg = efn(emb(neg_from), emb(neg_to), **energy_kw)
    if threshold is None:
        return best_threshold_metrics(e_pos, e_neg)
    return threshold_metrics(e_pos, e_neg, threshold)
