"""Taxonomy core: dense, array-first label maps.

The PyTorch port's own copy of ``learning_embeddings_tpu/hierarchy/
labelmap.py`` (pure numpy; the port imports nothing of the JAX package).
Kept line-for-line equal in behaviour; ``tests/test_torch_labelmap.py``
holds the two against each other.

Rebuilds the labelmap API of the reference (`data/db.py:1117-3594` —
`ETHECLabelMap{,Merged,MergedSmall}`, `Butterfly200LabelMap`,
`convert_child_of`, `get_one_hot`, `get_level_labels`, `get_children_of`,
`decode_children`) as a frozen dataclass of numpy arrays.  Where the
reference keeps per-parent python dicts (`child_of_family_ix`, ...), we keep

* ``parent_ix``   — (n_classes,) global parent index per node (-1 at roots),
* ``child_masks`` — per adjacent level pair, a dense bool matrix
  ``(levels[l], levels[l+1])`` with True where the level-(l+1) node is a
  child of the level-l node,

so the hierarchical losses (LastLevelCE bottom-up propagation, MaskedCE
top-down decode, HierarchicalSoftmax chaining) become masked matmuls and
gathers instead of dict walks (reference loss.py:75-86, 129-161, 219-236).

Indices are *relative within a level*; global index = relative + level_start.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "LabelMap",
    "build_labelmap",
    "toy_labelmap",
    "labelmap_from_records",
    "butterfly200_labelmap",
]


@dataclasses.dataclass(frozen=True)
class LabelMap:
    """A fixed multi-level taxonomy.

    Every node lives at exactly one level; every node at level l>0 has
    exactly one parent at level l-1 (a tree per level pair, as in the
    reference ETHEC/Butterfly200/CIFAR/FMNIST taxonomies).
    """

    level_names: Tuple[str, ...]
    #: per level, node name -> relative index
    name_to_ix: Tuple[Mapping[str, int], ...]
    #: per level, relative index -> node name
    ix_to_name: Tuple[Tuple[str, ...], ...]
    #: (n_classes,) global parent index, -1 for level-0 nodes
    parent_ix: np.ndarray
    #: per level pair l -> bool (levels[l], levels[l+1])
    child_masks: Tuple[np.ndarray, ...]

    # ---- derived (filled by __post_init__) ----
    levels: Tuple[int, ...] = dataclasses.field(init=False)
    level_start: np.ndarray = dataclasses.field(init=False)
    level_stop: np.ndarray = dataclasses.field(init=False)
    n_classes: int = dataclasses.field(init=False)

    def __post_init__(self):
        sizes = tuple(len(names) for names in self.ix_to_name)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
        stops = np.cumsum(sizes).astype(np.int32)
        object.__setattr__(self, "levels", sizes)
        object.__setattr__(self, "level_start", starts)
        object.__setattr__(self, "level_stop", stops)
        object.__setattr__(self, "n_classes", int(stops[-1]))
        # validation
        assert self.parent_ix.shape == (self.n_classes,)
        for l, mask in enumerate(self.child_masks):
            assert mask.shape == (sizes[l], sizes[l + 1]), (
                l, mask.shape, sizes)
            # every child has exactly one parent
            assert (mask.sum(axis=0) == 1).all(), f"level {l+1} orphan/multi-parent"

    # ------------------------------------------------------------------
    # reference-API parity helpers (db.py:3514-3563)
    # ------------------------------------------------------------------
    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def get_label_id(self, level_name: str, label_name: str) -> int:
        """Relative index of `label_name` at the level called `level_name`."""
        return self.name_to_ix[self.level_names.index(level_name)][label_name]

    def get_level_labels(self, *names: str) -> np.ndarray:
        """Per-level relative indices for a full path of node names
        (reference db.py:3525-3531)."""
        assert len(names) == self.n_levels
        return np.array(
            [self.name_to_ix[l][n] for l, n in enumerate(names)], dtype=np.int32
        )

    def get_one_hot(self, *names: str) -> np.ndarray:
        """Multi-hot vector over all n_classes with a 1 at each level's
        global index (reference db.py:3514-3520)."""
        retval = np.zeros(self.n_classes, dtype=np.float32)
        retval[self.global_labels(self.get_level_labels(*names))] = 1.0
        return retval

    def global_labels(self, level_labels: np.ndarray) -> np.ndarray:
        """Relative per-level labels -> global indices. Works batched."""
        level_labels = np.asarray(level_labels)
        return level_labels + self.level_start

    def get_children_of(self, c_ix: int, level_id: int) -> List[int]:
        """Relative indices at `level_id` reachable from relative parent
        `c_ix` at `level_id-1`; all of level 0 when level_id == 0
        (reference db.py:3533-3548)."""
        if level_id == 0:
            return list(range(self.levels[0]))
        return np.nonzero(self.child_masks[level_id - 1][c_ix])[0].tolist()

    def decode_children(self, level_labels: np.ndarray):
        """For a ground-truth path, per level the candidate (relative)
        children of the gt parent, and the gt's index *within* that
        candidate list (reference db.py:3550-3563)."""
        level_labels = np.asarray(level_labels)
        possible: Dict[str, List[int]] = {}
        new_level_labels: List[int] = []
        for l, name in enumerate(self.level_names):
            cand = self.get_children_of(
                int(level_labels[l - 1]) if l > 0 else -1, l)
            possible[name] = cand
            new_level_labels.append(cand.index(int(level_labels[l])))
        return possible, new_level_labels

    # ------------------------------------------------------------------
    # dense exports for jitted losses
    # ------------------------------------------------------------------
    def child_masks_f32(self) -> Tuple[np.ndarray, ...]:
        return tuple(m.astype(np.float32) for m in self.child_masks)

    def parent_of_global(self) -> np.ndarray:
        """(n_classes,) global parent; level-0 nodes point at themselves."""
        p = np.where(self.parent_ix < 0, np.arange(self.n_classes), self.parent_ix)
        return p.astype(np.int32)

    def full_child_mask(self) -> np.ndarray:
        """(n_classes, n_classes) bool direct-edge adjacency (parent->child)
        over global indices."""
        A = np.zeros((self.n_classes, self.n_classes), dtype=bool)
        child = np.arange(self.n_classes)
        has_parent = self.parent_ix >= 0
        A[self.parent_ix[has_parent], child[has_parent]] = True
        return A

    def level_of_global(self) -> np.ndarray:
        """(n_classes,) level id of each global index."""
        out = np.zeros(self.n_classes, dtype=np.int32)
        for l in range(self.n_levels):
            out[self.level_start[l]:self.level_stop[l]] = l
        return out

    def leaf_paths(self) -> np.ndarray:
        """(n_leaves, n_levels) relative level labels of each leaf's full
        ancestor path, ordered by leaf relative index."""
        n_leaves = self.levels[-1]
        paths = np.zeros((n_leaves, self.n_levels), dtype=np.int32)
        paths[:, -1] = np.arange(n_leaves)
        for l in range(self.n_levels - 2, -1, -1):
            child_global = self.global_labels_at_level(paths[:, l + 1], l + 1)
            paths[:, l] = self.parent_ix[child_global] - self.level_start[l]
        return paths

    def global_labels_at_level(self, rel: np.ndarray, level_id: int) -> np.ndarray:
        return np.asarray(rel) + self.level_start[level_id]


def build_labelmap(
    level_names: Sequence[str],
    names_by_level: Sequence[Sequence[str]],
    child_of_by_name: Sequence[Mapping[str, Sequence[str]]],
) -> LabelMap:
    """Construct a LabelMap from per-level name lists plus, for each adjacent
    level pair, a parent-name -> child-names mapping (the reference's
    `child_of_*` dict shape, db.py:1123+)."""
    name_to_ix = tuple(
        {n: i for i, n in enumerate(names)} for names in names_by_level
    )
    ix_to_name = tuple(tuple(names) for names in names_by_level)
    sizes = [len(n) for n in names_by_level]
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(int)

    n_classes = int(np.sum(sizes))
    parent_ix = np.full(n_classes, -1, dtype=np.int32)
    child_masks = []
    for l, mapping in enumerate(child_of_by_name):
        mask = np.zeros((sizes[l], sizes[l + 1]), dtype=bool)
        for parent_name, children in mapping.items():
            if parent_name not in name_to_ix[l]:
                continue
            p = name_to_ix[l][parent_name]
            for child_name in children:
                if child_name not in name_to_ix[l + 1]:
                    continue
                c = name_to_ix[l + 1][child_name]
                mask[p, c] = True
                parent_ix[starts[l + 1] + c] = starts[l] + p
        child_masks.append(mask)

    return LabelMap(
        level_names=tuple(level_names),
        name_to_ix=name_to_ix,
        ix_to_name=ix_to_name,
        parent_ix=parent_ix,
        child_masks=tuple(child_masks),
    )


def toy_labelmap(branching: int = 3, n_levels: int = 3) -> LabelMap:
    """Synthetic complete b-ary tree taxonomy (reference embed_toy.py:29-62
    `ToyGraph`): level l has branching**(l+1) nodes, node i at level l+1 is
    the child of node i // branching at level l."""
    level_names = tuple(f"level_{l}" for l in range(n_levels))
    names_by_level = [
        [f"L{l}_{i}" for i in range(branching ** (l + 1))] for l in range(n_levels)
    ]
    child_of = [
        {
            f"L{l}_{p}": [
                f"L{l+1}_{c}"
                for c in range(p * branching, (p + 1) * branching)
            ]
            for p in range(branching ** (l + 1))
        }
        for l in range(n_levels - 1)
    ]
    return build_labelmap(level_names, names_by_level, child_of)


def butterfly200_labelmap() -> LabelMap:
    """The Butterfly200 5/23/116/200 taxonomy (reference
    `Butterfly200LabelMap`, db.py:17-1115), shipped as frozen DATA in
    data/butterfly200_taxonomy.json (extracted by
    tools/extract_butterfly200.py) with reference index order preserved —
    usable without any dataset json."""
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "data",
                        "butterfly200_taxonomy.json")
    with open(path) as f:
        d = json.load(f)
    level_names = ("family", "subfamily", "genus", "genus_specific_epithet")
    names_by_level = [d["levels"][n] for n in level_names]
    child_of = [d["child_of"][n] for n in level_names[:-1]]
    lm = build_labelmap(level_names, names_by_level, child_of)
    assert lm.levels == (5, 23, 116, 200), lm.levels
    return lm


def labelmap_from_records(
    records: Sequence[Mapping[str, str]],
    level_keys: Sequence[str] = ("family", "subfamily", "genus", "specific_epithet"),
    merge_last_with: Optional[str] = "genus",
) -> LabelMap:
    """Build a labelmap from ETHEC-style specimen records (the reference
    regenerates its literal dicts the same way, db.py:3888-3917
    `generate_labelmap`).

    With ``merge_last_with='genus'`` the last level becomes the merged
    ``genus_specific_epithet`` leaf (`ETHECLabelMapMerged`, db.py:3565-3594).
    Node names are sorted for determinism.
    """
    level_keys = list(level_keys)

    def node_name(rec, l):
        key = level_keys[l]
        if merge_last_with and l == len(level_keys) - 1:
            return f"{rec[merge_last_with]}_{rec[key]}"
        return str(rec[key])

    n_levels = len(level_keys)
    names: List[set] = [set() for _ in range(n_levels)]
    child_pairs: List[set] = [set() for _ in range(n_levels - 1)]
    for rec in records:
        path = [node_name(rec, l) for l in range(n_levels)]
        for l, name in enumerate(path):
            names[l].add(name)
        for l in range(n_levels - 1):
            child_pairs[l].add((path[l], path[l + 1]))

    names_by_level = [sorted(s) for s in names]
    child_of = []
    for l in range(n_levels - 1):
        mapping: Dict[str, List[str]] = {}
        for p, c in sorted(child_pairs[l]):
            mapping.setdefault(p, []).append(c)
        child_of.append(mapping)

    final_names = list(level_keys)
    if merge_last_with:
        final_names[-1] = f"{merge_last_with}_{level_keys[-1]}"
    return build_labelmap(tuple(final_names), names_by_level, child_of)
