"""ETHEC database records: loading, encoding, stratified splitting.

The port's own copy of ``learning_embeddings_tpu/data/records.py``
(lines 36-149; numpy only):

* ``load_ethec_json``  — token-keyed specimen dict → record list
* ``encode_records``   — per-record level labels / leaf labels / image
  paths against a LabelMap
* ``stratified_split`` — leaf-stratified 80/10/10 with the reference's
  small-class rules (classes with < 3 samples dropped, < 10 split in
  thirds, remainder to val/test)
* ``filter_to_labelmap`` — debug-mode subset filtering
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

__all__ = [
    "load_ethec_json",
    "save_ethec_json",
    "leaf_name",
    "image_relpath",
    "multihot_from_level_labels",
    "encode_records",
    "stratified_split",
    "filter_to_labelmap",
    "EncodedDataset",
]


def load_ethec_json(path: str) -> List[dict]:
    with open(path) as f:
        db = json.load(f)
    return list(db.values())


def save_ethec_json(records: Sequence[dict], path: str) -> None:
    with open(path, "w") as f:
        json.dump({r["token"]: r for r in records}, f, indent=4)


def leaf_name(rec: Mapping) -> str:
    return f"{rec['genus']}_{rec['specific_epithet']}"


def image_relpath(rec: Mapping) -> str:
    return os.path.join(rec.get("image_path", ""), rec["image_name"])


def multihot_from_level_labels(level_labels: np.ndarray,
                               labelmap) -> np.ndarray:
    """(N, n_classes) multi-hot over all levels."""
    n = len(level_labels)
    mh = np.zeros((n, labelmap.n_classes), np.float32)
    glob = level_labels + labelmap.level_start[None, :]
    mh[np.arange(n)[:, None], glob] = 1.0
    return mh


@dataclasses.dataclass
class EncodedDataset:
    """Array-encoded dataset ready for the input pipeline."""

    level_labels: np.ndarray        # (N, L) int32, relative per level
    leaf_labels: np.ndarray         # (N,) int32
    image_paths: List[str]          # relative to the image root
    tokens: List[str]

    def __len__(self):
        return len(self.leaf_labels)

    def multihot(self, labelmap) -> np.ndarray:
        return multihot_from_level_labels(self.level_labels, labelmap)


def encode_records(records: Sequence[Mapping], labelmap) -> EncodedDataset:
    L = labelmap.n_levels
    ll = np.zeros((len(records), L), np.int32)
    paths, tokens = [], []
    for i, rec in enumerate(records):
        names = (rec["family"], rec["subfamily"], rec["genus"], leaf_name(rec))
        ll[i] = labelmap.get_level_labels(*names[:L])
        paths.append(image_relpath(rec))
        tokens.append(rec.get("token", str(i)))
    return EncodedDataset(
        level_labels=ll, leaf_labels=ll[:, -1].copy(),
        image_paths=paths, tokens=tokens)


def filter_to_labelmap(records: Sequence[Mapping], labelmap) -> List[dict]:
    """Keep records whose full path exists in `labelmap` (debug subsets)."""
    out = []
    for rec in records:
        try:
            labelmap.get_level_labels(
                rec["family"], rec["subfamily"], rec["genus"], leaf_name(rec))
            out.append(dict(rec))
        except KeyError:
            continue
    return out


def stratified_split(
    records: Sequence[Mapping],
    labelmap,
    ratios: Tuple[float, float, float] = (0.8, 0.1, 0.1),
    minimum_samples: int = 3,
    minimum_samples_to_use_split: int = 10,
) -> Tuple[List[dict], List[dict], List[dict]]:
    """Leaf-stratified split, per leaf class in database order:
    * < minimum_samples: dropped entirely,
    * < minimum_samples_to_use_split: n//3 each,
    * else: floor(ratio·n) each;
    leftovers: ceil(half) to val, floor(half) to test; test takes the LAST
    n_test samples, so the splits never overlap. With test_ratio = 0 the
    test split is empty."""
    by_leaf: Dict[int, List[int]] = {}
    for i, rec in enumerate(records):
        lid = labelmap.get_label_id(labelmap.level_names[-1], leaf_name(rec))
        by_leaf.setdefault(lid, []).append(i)

    train, val, test = [], [], []
    for lid, idxs in by_leaf.items():
        n = len(idxs)
        if n < minimum_samples:
            continue
        if n < minimum_samples_to_use_split:
            n_tr = n_va = n_te = n // 3
        else:
            n_tr = int(ratios[0] * n)
            n_va = int(ratios[1] * n)
            n_te = int(ratios[2] * n)
        rem = n - (n_tr + n_va + n_te)
        n_va += rem % 2 + rem // 2
        n_te += rem // 2
        train += [records[i] for i in idxs[:n_tr]]
        val += [records[i] for i in idxs[n_tr:n_tr + n_va]]
        test += [records[i] for i in idxs[n - n_te:]]
    return train, val, test
