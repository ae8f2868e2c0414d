"""A frozen copy of the host negative sampler of the joint image + label
graph (``sample_joint_negatives_np``), cut to the path the joint cell
runs (``pick_per_level``, no level hidden), so that the reference draws
the negatives the measured trainer should draw from the same
``np.random.RandomState``. `graph` is any object with the attributes of
``Graph`` below. Nothing here imports the measured package.

The r-th of each edge's R draws of a side corrupts it at level
r mod (L + 1), L the label levels and level L the images; each draw is
uniform over its candidates:
corrupt 'to' given anchor u (label level l):
    level-l labels − descendants(u) − {u}
corrupt 'to' given anchor u (image level L):
    u label : images that are NOT descendants of u
    u image : labels − descendants(u) − {u}
corrupt 'from' given anchor v (label level l):
    v label : level-l labels − ancestors(v) − {v}
    v image : level-l labels − {v's ancestor at level l}
corrupt 'from' given anchor v (image level L):
    v label : all images (images never reach labels)
    v image : labels − ancestors(v) − {v}
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Graph(NamedTuple):
    """label_closure (n_labels, n_labels) bool, [u, v] where u is a strict
    ancestor of v; image_paths_global (n_images, L) the global ancestor of
    each image per level; level_start / level_stop per level."""

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


def sample_joint_negatives_np(graph, neg_to_pos_ratio: int,
                              rng: np.random.RandomState,
                              pos_from: np.ndarray, pos_to: np.ndarray):
    """(neg_from, neg_to), 2·R per positive edge: for edge i, entries
    2Ri + r corrupt its 'to' and 2Ri + R + r its 'from'. A label that is
    an ancestor of every image has no image to corrupt with: that
    raises, as the trainer does on a train graph."""
    nl, ni, L = graph.n_labels, graph.n_images, graph.n_levels
    R = int(neg_to_pos_ratio)
    B = len(pos_from)
    closure = graph.label_closure
    img_paths = graph.image_paths_global
    starts, stops = graph.level_start, graph.level_stop

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

    # per level, images sorted by ancestor: a label's descendants form one
    # contiguous run, and a uniform draw over the rest is randint + a skip
    orders = {}

    def image_not_descended(u):
        lvl = int(np.searchsorted(stops, u, side="right"))
        if lvl not in orders:
            order_l = np.argsort(img_paths[:, lvl], kind="stable")
            orders[lvl] = (order_l, img_paths[order_l, lvl])
        order_l, anc = orders[lvl]
        start = int(np.searchsorted(anc, u, side="left"))
        cnt = int(np.searchsorted(anc, u, side="right")) - start
        if ni - cnt <= 0:
            raise ValueError(f"label {u} is an ancestor of every image: "
                             "no negative-image candidates")
        j = int(rng.randint(ni - cnt))
        if j >= start:
            j += cnt
        return int(order_l[j])

    def choice(mask):
        cand = np.nonzero(mask)[0]
        if len(cand) == 0:
            cand = np.arange(len(mask))
        return int(cand[rng.randint(len(cand))])

    def in_level(lvl):
        return (np.arange(nl) >= starts[lvl]) & (np.arange(nl) < stops[lvl])

    neg_from = np.empty(2 * R * B, np.int32)
    neg_to = np.empty(2 * R * B, np.int32)
    for i in range(B):
        u, v = int(pos_from[i]), int(pos_to[i])
        for r in range(R):
            lvl = r % (L + 1)
            if lvl < L:
                c = choice(label_cands_to(u) & in_level(lvl))
            else:
                c = (choice(label_cands_to(u)) if u >= nl
                     else nl + image_not_descended(u))
            neg_from[2 * R * i + r] = u
            neg_to[2 * R * i + r] = c
            if lvl < L:
                c = choice(label_cands_from(v) & in_level(lvl))
            else:
                c = (choice(label_cands_from(v)) if v >= nl
                     else nl + rng.randint(ni))
            neg_from[2 * R * i + r + R] = c
            neg_to[2 * R * i + r + R] = v
    return neg_from, neg_to
