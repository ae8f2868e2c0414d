"""Structured negative sampling for the joint (image + label) graph: the
port of ``learning_embeddings_tpu/losses/joint_sampling.py``.

* ``sample_joint_negatives_np`` draws on the host; the same
  ``np.random.RandomState`` gives the same draws as the JAX package's.
* ``make_joint_negative_sampler`` (the fc7 trainer's) draws on the device
  from an explicit ``torch.Generator``: the same candidate sets, pass
  cycle and slot layout as the JAX sampler, the same distribution (the
  draws themselves differ).

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
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

__all__ = ["JointGraph", "build_joint_graph", "make_joint_negative_sampler",
           "sample_joint_negatives_np", "save_joint_graph",
           "load_joint_graph", "filter_stage_edges"]


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


def _bounded(generator: torch.Generator, n: torch.Tensor,
             shape) -> torch.Tensor:
    """Uniform integers in [0, n) per element (n ≥ 1, broadcast to
    `shape`): floor(u · n) clamped to n − 1."""
    u = torch.rand(shape, generator=generator, device=n.device)
    return torch.minimum((u * n).long(), n - 1)


def make_joint_negative_sampler(
    graph: JointGraph,
    neg_to_pos_ratio: int,
    *,
    pick_per_level: bool = True,
    levels_to_hide: Sequence[int] = (),
    device="cpu",
) -> Callable:
    """(generator, pos_from, pos_to) -> (neg_from, neg_to), each (B·2R,)
    int64 on `device`, drawn on the device from `generator`. Slot 2R·i + r
    keeps pos_from[i] and corrupts 'to'; slot 2R·i + R + r keeps pos_to[i]
    and corrupts 'from'. Pass r draws at level visible[r % len(visible)]
    (levels 0..L−1, then L = images, minus `levels_to_hide`); without
    `pick_per_level` every pass draws from the whole row (labels and
    images). Build one per curriculum stage.

    On the image pass the corrupted node's type follows the anchor: a
    label anchor corrupts with an image (for 'to', an image not descended
    from it, by an O(1) draw over each level's images sorted by their
    ancestor, where a label's descendants form one run that the draw
    skips), an image anchor with a label. Raises ValueError when that draw
    has no candidate: a visible label that is an ancestor of every train
    image."""
    nl, ni, L = graph.n_labels, graph.n_images, graph.n_levels
    R = int(neg_to_pos_ratio)
    hidden = set(levels_to_hide)
    visible = [l for l in range(L + 1) if l not in hidden]
    pass_levels = ([visible[r % len(visible)] for r in range(R)]
                   if pick_per_level else None)
    starts = np.asarray(graph.level_start)
    stops = np.asarray(graph.level_stop)
    np_paths = np.asarray(graph.image_paths_global)

    # per level, image rows sorted by their ancestor: label u's
    # descendants are the run [run_start[u], + run_cnt[u]) of that order
    order = np.zeros((L, ni), np.int64)
    run_start = np.zeros((L, nl), np.int64)
    run_cnt = np.zeros((L, nl), np.int64)
    level_of_label = np.zeros(nl, np.int64)
    for l in range(L):
        order[l] = np.argsort(np_paths[:, l], kind="stable")
        anc = np_paths[order[l], l]
        labels = np.arange(int(starts[l]), int(stops[l]))
        lo = np.searchsorted(anc, labels, side="left")
        run_start[l, labels] = lo
        run_cnt[l, labels] = np.searchsorted(anc, labels, side="right") - lo
        level_of_label[labels] = l
    if pass_levels is not None and L in pass_levels:
        # a visible label every image descends from has no image to
        # corrupt with (the clamped draw would return a positive); hidden
        # labels never anchor a draw (their edges are filtered out)
        empty = run_cnt == ni
        for l in hidden:
            if 0 <= l < L:
                empty[:, int(starts[l]):int(stops[l])] = False
        if empty.any():
            bad = [int(u) for u in np.nonzero(empty.any(0))[0]]
            raise ValueError(
                f"labels {bad} are ancestors of EVERY train image — the "
                "image-level negative pass has no candidates for them; "
                "hide that level or drop pick_per_level")

    def put(a):
        return torch.as_tensor(a, device=device)

    closure = put(np.asarray(graph.label_closure, bool))
    closure_t = closure.T.contiguous()
    img_paths = put(np_paths.astype(np.int64))
    img_paths_t = img_paths.T.contiguous()
    order, run_start, run_cnt, level_of_label = map(
        put, (order, run_start, run_cnt, level_of_label))
    n_images = put(np.int64(ni))
    if pass_levels is not None:
        ix = np.arange(nl)
        # the label candidates of each pass beyond the anchor's own: its
        # level's labels; on the image pass, where an image anchor draws a
        # label, every label
        pass_label_mask = put(np.stack([
            (ix >= starts[l]) & (ix < stops[l]) if l < L
            else np.ones(nl, bool) for l in pass_levels]))     # (R, nl)
        image_pass = put(np.asarray(pass_levels) == L)       # (R,)
        any_image_pass = L in pass_levels

    from .margin import masked_uniform_categorical as categorical

    def label_mask_to(u):
        """(B, nl): labels that are negative successors of u."""
        u_lab = torch.clamp_max(u, nl - 1)
        m = (~closure[u_lab]).scatter_(1, u_lab[:, None], False)
        return m | (u >= nl)[:, None]   # an image has no successor

    def label_mask_from(v):
        """(B, nl): labels that are negative predecessors of v."""
        v_lab = torch.clamp_max(v, nl - 1)
        anc_label = closure_t[v_lab].scatter_(1, v_lab[:, None], True)
        anc_img = torch.zeros_like(anc_label).scatter_(
            1, img_paths[torch.clamp_min(v - nl, 0)], True)
        return ~torch.where((v >= nl)[:, None], anc_img, anc_label)

    def image_not_descended(generator, u):
        """(B, R) uniform image rows not descended from labels u."""
        u_lab = torch.clamp_max(u, nl - 1)
        lvl = level_of_label[u_lab]
        start = run_start[lvl, u_lab][:, None]
        cnt = run_cnt[lvl, u_lab][:, None]
        j = _bounded(generator, torch.clamp_min(ni - cnt, 1),
                     (u.shape[0], R))
        j = j + torch.where(j >= start, cnt, 0)
        return order[lvl[:, None], torch.clamp_max(j, ni - 1)]

    def side(generator, anchors, corrupt_to: bool):
        """(B, R) corrupted node ids for one side."""
        B = anchors.shape[0]
        lab_mask = (label_mask_to if corrupt_to else label_mask_from)(
            anchors)
        is_image = anchors >= nl
        if pass_levels is None:
            # unrestricted: labels and images in one row
            self_col = torch.zeros((B, ni), dtype=torch.bool,
                                   device=anchors.device).scatter_(
                1, torch.clamp_min(anchors - nl, 0)[:, None], True) \
                & is_image[:, None]
            if corrupt_to:
                u_lab = torch.clamp_max(anchors, nl - 1)
                not_desc = img_paths_t[level_of_label[u_lab]] \
                    != u_lab[:, None]
                img_mask = torch.where(is_image[:, None], ~self_col,
                                       not_desc)
            else:
                img_mask = ~self_col   # images are nobody's successor
            full = torch.cat([lab_mask, img_mask], 1)
            return categorical(generator, full[:, None].expand(B, R, -1))
        cols = categorical(generator,
                           lab_mask[:, None] & pass_label_mask[None])
        if any_image_pass:
            img_pick = nl + (image_not_descended(generator, anchors)
                             if corrupt_to else
                             _bounded(generator, n_images, (B, R)))
            cols = torch.where(image_pass[None] & ~is_image[:, None],
                               img_pick, cols)
        return cols

    def sample(generator, pos_from, pos_to):
        B = pos_from.shape[0]
        corrupted_to = side(generator, pos_from, corrupt_to=True)
        corrupted_from = side(generator, pos_to, corrupt_to=False)
        nf = torch.cat([pos_from[:, None].expand(B, R), corrupted_from], 1)
        nt = torch.cat([corrupted_to, pos_to[:, None].expand(B, R)], 1)
        return nf.reshape(-1), nt.reshape(-1)

    return sample


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
