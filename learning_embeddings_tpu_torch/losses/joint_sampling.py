"""Structured negative sampling for the joint (image + label) graph: the
port's numpy copy of ``learning_embeddings_tpu/losses/joint_sampling.py``
(lines 52-169, 366-501). The same ``np.random.RandomState`` gives the same
draws as the JAX package's ``sample_joint_negatives_np``.

Facts of the combined graph that make a dense negative adjacency
unnecessary:
  * label→label closure edges: the labelmap's transitive closure,
  * label→image edges: EVERY ancestor level of the image's path,
  * images have no outgoing edges.
So membership in the negative adjacency is decidable from the small
label-closure matrix and each image's (L,) ancestor path.

Candidate sets (uniform draws over each):
corrupt 'to' given anchor u (pass at label level l):
    u label : level-l labels − descendants(u) − {u}
    u image : all level-l labels                    (images have no out-edges)
corrupt 'to' given anchor u (pass at image level L):
    u label : images that are NOT descendants of u
    u image : labels − descendants(u) − {u}
corrupt 'from' given anchor v (label level l):
    v label : level-l labels − ancestors(v) − {v}
    v image : level-l labels − {v's ancestor at level l}
corrupt 'from' given anchor v (image level L):
    v label : all images (images never reach labels)
    v image : labels − ancestors(v) − {v}
The image-pass type rule follows the ANCHOR (the kept endpoint).

Curriculum ``levels_to_hide`` removes those levels from the pass cycle.
The fc7 trainer's on-device sampler (``make_joint_negative_sampler``) is not
ported yet (ROADMAP.md queue A item 15).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["JointGraph", "build_joint_graph", "sample_joint_negatives_np",
           "save_joint_graph", "load_joint_graph", "filter_stage_edges"]


class JointGraph(NamedTuple):
    """Static arrays describing the combined train graph.

    label_closure: (n_labels, n_labels) bool transitive closure (labels).
    image_paths_global: (n_images, L) int32 — each train image's ancestor
        label (global index) per level. Image node id = n_labels + row.
    level_start/stop: per-level label ranges.
    """

    label_closure: np.ndarray
    image_paths_global: np.ndarray
    level_start: np.ndarray
    level_stop: np.ndarray

    @property
    def n_labels(self) -> int:
        return self.label_closure.shape[0]

    @property
    def n_images(self) -> int:
        return self.image_paths_global.shape[0]

    @property
    def n_levels(self) -> int:
        return self.image_paths_global.shape[1]

    def is_image(self, ids):
        return ids >= self.n_labels

    def positive_mask(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """True where (u, v) is a closure edge of the combined graph."""
        u = np.asarray(u)
        v = np.asarray(v)
        out = np.zeros(u.shape, bool)
        both_label = (u < self.n_labels) & (v < self.n_labels)
        out[both_label] = self.label_closure[u[both_label], v[both_label]]
        li = (u < self.n_labels) & (v >= self.n_labels)
        if li.any():
            paths = self.image_paths_global[v[li] - self.n_labels]
            out[li] = (paths == u[li][:, None]).any(axis=1)
        return out


def build_joint_graph(labelmap, train_level_labels: np.ndarray):
    """(JointGraph, train_edges) from the train split's per-sample level
    labels — the reference's create_combined_graphs (oe.py:417-491):

    * label→label direct edges observed in the data, transitively closed,
    * label→image edges from EVERY ancestor level (basic edges; the closure
      adds nothing on top for images),
    * train_edges = the basic skeleton (G_train_skeleton_full)."""
    from ..hierarchy.graph import label_graph_from_paths, transitive_closure

    ll = np.asarray(train_level_labels)
    basic = label_graph_from_paths(ll, labelmap)
    closure = transitive_closure(basic)
    glob = ll + labelmap.level_start[None, :]
    n_img, L = glob.shape
    nl = labelmap.n_classes
    label_edges = np.stack(np.nonzero(basic), axis=1)
    img_nodes = nl + np.arange(n_img)
    img_edges = np.stack(
        [glob.reshape(-1),
         np.repeat(img_nodes, L)], axis=1)
    train_edges = np.concatenate([label_edges, img_edges]).astype(np.int32)
    graph = JointGraph(
        label_closure=closure,
        image_paths_global=glob.astype(np.int32),
        level_start=np.asarray(labelmap.level_start),
        level_stop=np.asarray(labelmap.level_stop),
    )
    return graph, train_edges


def save_joint_graph(path: str, graph: JointGraph,
                     train_edges: np.ndarray) -> None:
    """Persist the combined graph (replaces the reference's gpickle +
    neg_adjacency.npy cache, oe.py:468-483 / load_combined_graphs)."""
    np.savez_compressed(
        path, label_closure=graph.label_closure,
        image_paths_global=graph.image_paths_global,
        level_start=graph.level_start, level_stop=graph.level_stop,
        train_edges=train_edges)


def load_joint_graph(path: str):
    """(JointGraph, train_edges) from save_joint_graph output."""
    blob = np.load(path)
    graph = JointGraph(
        label_closure=blob["label_closure"],
        image_paths_global=blob["image_paths_global"],
        level_start=blob["level_start"],
        level_stop=blob["level_stop"],
    )
    return graph, blob["train_edges"]


def filter_stage_edges(graph: JointGraph, train_edges: np.ndarray,
                       hidden) -> np.ndarray:
    """Curriculum stage filter: drop every edge touching a hidden label
    level (oe_h.py:1534-1572). Raises if the stage would be empty — the
    silent alternative is training on edges from the very levels the
    curriculum is supposed to hide."""
    hidden = tuple(hidden)
    if not hidden:
        return train_edges
    g = graph
    lvl_of = np.full(g.n_labels + g.n_images, g.n_levels, np.int32)
    for l in range(g.n_levels):
        lvl_of[g.level_start[l]:g.level_stop[l]] = l
    e = np.asarray(train_edges)
    keep = (~np.isin(lvl_of[e[:, 0]], hidden)
            & ~np.isin(lvl_of[e[:, 1]], hidden))
    if not keep.any():
        raise ValueError(
            f"curriculum stage hiding levels {hidden} leaves no training "
            "edges — fix the schedule")
    return e[keep]


def sample_joint_negatives_np(
    graph: JointGraph,
    neg_to_pos_ratio: int,
    rng: np.random.RandomState,
    pos_from: np.ndarray,
    pos_to: np.ndarray,
    *,
    pick_per_level: bool = True,
    levels_to_hide=(),
    empty_image_complement: str = "raise",
):
    """Host-side negative sampler (numpy RNG) — used by the end-to-end CNN
    joint trainer, whose image pixels must be gathered on the host before
    the step, and by the joint edge metrics.

    empty_image_complement: what to do when a label is an ancestor of
    EVERY image in `graph` (the image-level pass has no candidates for
    it). 'raise' fails — right for TRAIN graphs, where the caller can hide the level or drop
    pick_per_level. 'widen' falls back to the label candidate set for
    that draw (the unrestricted pass restricted to its non-empty half) —
    right for EVAL splits / subsamples, whose composition the trainer
    config cannot fix (a tiny split where one label covers every image
    must still produce a metric)."""
    nl, ni, L = graph.n_labels, graph.n_images, graph.n_levels
    R = int(neg_to_pos_ratio)
    B = len(pos_from)
    closure = graph.label_closure
    img_paths = graph.image_paths_global
    starts, stops = graph.level_start, graph.level_stop

    visible = [l for l in range(L + 1) if l not in set(levels_to_hide)]

    def label_cands_to(u):
        if u >= nl:
            return np.ones(nl, bool)
        m = ~closure[u].copy()
        m[u] = False
        return m

    def label_cands_from(v):
        if v >= nl:
            m = np.ones(nl, bool)
            m[img_paths[v - nl]] = False
            return m
        m = ~closure[:, v].copy()
        m[v] = False
        return m

    # run-range image-negative draws:
    # per level, images sorted by ancestor — a label's descendants form one
    # contiguous run; uniform over the complement is randint + a skip
    _orders = {}

    def _run_range(u):
        lvl = int(np.searchsorted(stops, u, side="right"))
        if lvl not in _orders:
            order_l = np.argsort(img_paths[:, lvl], kind="stable")
            _orders[lvl] = (order_l, img_paths[order_l, lvl])
        order_l, anc = _orders[lvl]
        lo = int(np.searchsorted(anc, u, side="left"))
        hi = int(np.searchsorted(anc, u, side="right"))
        return order_l, lo, hi - lo

    def image_not_descended(u):
        """Uniform image row not descended from u, or None when no image
        qualifies and the caller asked to widen (see docstring)."""
        order_l, start, cnt = _run_range(u)
        n_compl = ni - cnt
        if n_compl <= 0:
            if empty_image_complement == "widen":
                return None
            # no image is a valid negative for u — fail (as the
            # reference's crash on an empty candidate set) instead of
            # corrupting the loss
            raise ValueError(
                f"label {u} is an ancestor of every image in this graph — "
                "no negative-image candidates (train graph: hide its level "
                "or drop pick_per_level; eval split/subsample: pass "
                "empty_image_complement='widen')")
        j = int(rng.randint(n_compl))
        if j >= start:
            j += cnt
        return int(order_l[j])

    def choice(mask, offset=0):
        cand = np.nonzero(mask)[0]
        if len(cand) == 0:
            cand = np.arange(len(mask))
        return offset + int(cand[rng.randint(len(cand))])

    neg_from = np.empty(2 * R * B, np.int32)
    neg_to = np.empty(2 * R * B, np.int32)
    for i in range(B):
        u, v = int(pos_from[i]), int(pos_to[i])
        for r in range(R):
            lvl = visible[r % len(visible)] if pick_per_level else None
            # corrupt 'to' given u
            if lvl is None:
                lm = label_cands_to(u)
                if u < nl:
                    lvl_u = int(np.searchsorted(stops, u, side="right"))
                    im = img_paths[:, lvl_u] != u
                else:
                    im = ~np.eye(1, ni, u - nl, dtype=bool)[0]
                full = np.concatenate([lm, im])
                c = choice(full)
            elif lvl < L:
                m = label_cands_to(u) & (np.arange(nl) >= starts[lvl]) \
                    & (np.arange(nl) < stops[lvl])
                c = choice(m)
            else:
                # anchor-based type rule (see the module docstring)
                row = None if u >= nl else image_not_descended(u)
                c = (choice(label_cands_to(u)) if row is None
                     else nl + row)
            neg_from[2 * R * i + r] = u
            neg_to[2 * R * i + r] = c
            # corrupt 'from' given v
            if lvl is None:
                lm = label_cands_from(v)
                im = np.ones(ni, bool)
                if v >= nl:
                    im[v - nl] = False
                c = choice(np.concatenate([lm, im]))
            elif lvl < L:
                m = label_cands_from(v) & (np.arange(nl) >= starts[lvl]) \
                    & (np.arange(nl) < stops[lvl])
                c = choice(m)
            else:
                c = (choice(label_cands_from(v)) if v >= nl
                     else nl + rng.randint(ni))
            neg_from[2 * R * i + r + R] = c
            neg_to[2 * R * i + r + R] = v
    return neg_from, neg_to
