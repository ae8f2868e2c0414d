"""The Butterfly200 taxonomy (5/23/116/200 = 344 nodes) as plain numpy
arrays, read from the frozen copy beside this file.

Global node ids run level by level, each level in the file's name order:
node i of level l has the id ``level_start[l] + i``. Nothing here imports
the measured package.
"""

from __future__ import annotations

import json
import os

import numpy as np

LEVEL_NAMES = ("family", "subfamily", "genus", "genus_specific_epithet")
TAXONOMY_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "butterfly200_taxonomy.json")


class Taxonomy:
    """levels, level_start / level_stop, parent (global ids, −1 at the
    top) and the leaf paths (n_leaves, n_levels) of relative ids."""

    def __init__(self, path: str = TAXONOMY_FILE):
        with open(path) as f:
            d = json.load(f)
        names = [list(d["levels"][n]) for n in LEVEL_NAMES]
        self.levels = tuple(len(n) for n in names)
        self.level_start = np.concatenate(
            [[0], np.cumsum(self.levels)[:-1]]).astype(np.int64)
        self.level_stop = np.cumsum(self.levels).astype(np.int64)
        self.n_classes = int(self.level_stop[-1])
        self.parent = np.full(self.n_classes, -1, np.int64)
        for l, level in enumerate(LEVEL_NAMES[:-1]):
            index = {n: i for i, n in enumerate(names[l])}
            child_index = {n: i for i, n in enumerate(names[l + 1])}
            for parent, children in d["child_of"][level].items():
                if parent not in index:
                    continue
                for c in children:
                    if c in child_index:
                        self.parent[self.level_start[l + 1] + child_index[c]] \
                            = self.level_start[l] + index[parent]
        L = len(self.levels)
        paths = np.zeros((self.levels[-1], L), np.int64)
        node = self.level_start[-1] + np.arange(self.levels[-1])
        for l in range(L - 1, -1, -1):
            paths[:, l] = node - self.level_start[l]
            node = self.parent[node]
        self.leaf_paths = paths

    def multihot(self, level_labels: np.ndarray) -> np.ndarray:
        """(B, n_classes) f32 with a 1 at every node of each row's path."""
        glob = np.asarray(level_labels) + self.level_start[None, :]
        out = np.zeros((len(glob), self.n_classes), np.float32)
        np.put_along_axis(out, glob, 1.0, axis=1)
        return out


def observed_closure(paths_global: np.ndarray, n_labels: int) -> np.ndarray:
    """(n, n) bool: [u, v] where u lies above v on some row's path of
    global ids (the label edges a training split shows, closed)."""
    out = np.zeros((n_labels, n_labels), bool)
    L = paths_global.shape[1]
    for a in range(L):
        for b in range(a + 1, L):
            out[paths_global[:, a], paths_global[:, b]] = True
    return out
