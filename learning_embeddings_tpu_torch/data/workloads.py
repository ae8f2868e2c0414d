"""CIFAR-10/100 and FashionMNIST hierarchical workloads: the port's copy of
``learning_embeddings_tpu/data/workloads.py`` (numpy, on the port's
``LabelMap``).

Counterparts of the reference's hand-rolled taxonomies and dataset wrappers
(`labelmap_CIFAR10` finetuner.py:534-577, `labelmap_CIFAR100`
finetuner.py:378-531, `labelmap_FMNIST` fashion_mnist.py:170-208,
`Cifar10Hierarchical`/`FMNISTHierarchical` wrappers, and the stratified
80/10/10 index splits `cifar10_set_indices`/`FMNIST_set_indices`).

The datasets load from local files only (CIFAR python pickles,
FashionMNIST idx files; ``FileNotFoundError`` otherwise);
``synthetic_array_dataset`` is the stand-in the CLIs fall back to. An
``ArrayDataset`` is what ``ImagePipeline``'s in-memory branch reads.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Dict, Optional, Tuple

import numpy as np

from ..hierarchy import LabelMap, build_labelmap

__all__ = [
    "cifar10_labelmap",
    "cifar100_labelmap",
    "fmnist_labelmap",
    "load_cifar10",
    "load_cifar100",
    "load_fmnist",
    "synthetic_array_dataset",
    "stratified_index_split",
    "ArrayDataset",
]

# ---------------------------------------------------------------------------
# taxonomies
# ---------------------------------------------------------------------------

_CIFAR10_CLASSES = ("plane", "car", "bird", "cat", "deer", "dog", "frog",
                    "horse", "ship", "truck")
# class -> (family, subfamily), reference finetuner.py:547-559
_CIFAR10_MAP = {
    "plane": ("non_living", "craft"),
    "car": ("non_living", "vehicle"),
    "bird": ("living", "non_land"),
    "cat": ("living", "land"),
    "deer": ("living", "land"),
    "dog": ("living", "land"),
    "frog": ("living", "non_land"),
    "horse": ("living", "land"),
    "ship": ("non_living", "craft"),
    "truck": ("non_living", "vehicle"),
}


def cifar10_labelmap() -> LabelMap:
    """3 levels: 2 families / 4 subfamilies / 10 classes."""
    return build_labelmap(
        ("family", "subfamily", "classes"),
        [
            ["living", "non_living"],
            ["non_land", "land", "vehicle", "craft"],
            list(_CIFAR10_CLASSES),
        ],
        [
            {"living": ["non_land", "land"],
             "non_living": ["vehicle", "craft"]},
            {sf: [c for c in _CIFAR10_CLASSES if _CIFAR10_MAP[c][1] == sf]
             for sf in ["non_land", "land", "vehicle", "craft"]},
        ],
    )


# standard CIFAR-100 coarse -> fine grouping (the dataset's own 20
# superclasses; the reference hardcodes the same mapping,
# finetuner.py:472-531)
_CIFAR100_COARSE_TO_FINE = {
    "aquatic mammals": ["beaver", "dolphin", "otter", "seal", "whale"],
    "fish": ["aquarium_fish", "flatfish", "ray", "shark", "trout"],
    "flowers": ["orchid", "poppy", "rose", "sunflower", "tulip"],
    "food containers": ["bottle", "bowl", "can", "cup", "plate"],
    "fruit and vegetables": ["apple", "mushroom", "orange", "pear",
                             "sweet_pepper"],
    "household electrical device": ["clock", "computer_keyboard", "lamp",
                                    "telephone", "television"],
    "household furniture": ["bed", "chair", "couch", "table", "wardrobe"],
    "insects": ["bee", "beetle", "butterfly", "caterpillar", "cockroach"],
    "large carnivores": ["bear", "leopard", "lion", "tiger", "wolf"],
    "large man-made outdoor things": ["bridge", "castle", "house", "road",
                                      "skyscraper"],
    "large natural outdoor scenes": ["cloud", "forest", "mountain", "plain",
                                     "sea"],
    "large omnivores and herbivores": ["camel", "cattle", "chimpanzee",
                                       "elephant", "kangaroo"],
    "medium-sized mammals": ["fox", "porcupine", "possum", "raccoon",
                             "skunk"],
    "non-insect invertebrates": ["crab", "lobster", "snail", "spider",
                                 "worm"],
    "people": ["baby", "boy", "girl", "man", "woman"],
    "reptiles": ["crocodile", "dinosaur", "lizard", "snake", "turtle"],
    "small mammals": ["hamster", "mouse", "rabbit", "shrew", "squirrel"],
    "trees": ["maple_tree", "oak_tree", "palm_tree", "pine_tree",
              "willow_tree"],
    "vehicles 1": ["bicycle", "bus", "motorcycle", "pickup_truck", "train"],
    "vehicles 2": ["lawn_mower", "rocket", "streetcar", "tank", "tractor"],
}


def cifar100_labelmap() -> LabelMap:
    """2 levels: 20 coarse / 100 fine."""
    coarse = list(_CIFAR100_COARSE_TO_FINE)
    fine = sorted(f for fs in _CIFAR100_COARSE_TO_FINE.values() for f in fs)
    return build_labelmap(
        ("family", "classes"),
        [coarse, fine],
        [_CIFAR100_COARSE_TO_FINE],
    )


_FMNIST_CLASSES = ("T-shirt_top", "Trouser", "Pullover", "Dress", "Coat",
                   "Sandal", "Shirt", "Sneaker", "Bag", "Ankle boot")
# class -> family, reference fashion_mnist.py:181-192
_FMNIST_MAP = {
    "T-shirt_top": "tops", "Trouser": "bottoms", "Pullover": "tops",
    "Dress": "tops", "Coat": "tops", "Sandal": "footwear", "Shirt": "tops",
    "Sneaker": "footwear", "Bag": "accessories", "Ankle boot": "footwear",
}


def fmnist_labelmap() -> LabelMap:
    """2 levels: 4 families / 10 classes."""
    return build_labelmap(
        ("family", "classes"),
        [["tops", "bottoms", "accessories", "footwear"],
         list(_FMNIST_CLASSES)],
        [{fam: [c for c in _FMNIST_CLASSES if _FMNIST_MAP[c] == fam]
          for fam in ["tops", "bottoms", "accessories", "footwear"]}],
    )


# ---------------------------------------------------------------------------
# array datasets
# ---------------------------------------------------------------------------

class ArrayDataset:
    """In-memory image dataset: images (N, H, W, C) uint8 + per-level
    labels. API-compatible with EncodedDataset for the runners."""

    def __init__(self, images: np.ndarray, leaf_labels: np.ndarray,
                 labelmap: LabelMap):
        self.images = images
        paths = labelmap.leaf_paths()
        self.level_labels = paths[leaf_labels].astype(np.int32)
        self.leaf_labels = np.asarray(leaf_labels, np.int32)
        self.labelmap = labelmap
        self.image_paths = [f"mem://{i}" for i in range(len(images))]

    def __len__(self):
        return len(self.leaf_labels)

    def multihot(self, labelmap) -> np.ndarray:
        from .records import multihot_from_level_labels

        return multihot_from_level_labels(self.level_labels, labelmap)


def load_cifar10(root: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(train_images, train_labels, test_images, test_labels) from the
    python-pickle batches under <root>/cifar-10-batches-py."""
    d = os.path.join(root, "cifar-10-batches-py")

    def read(name):
        with open(os.path.join(d, name), "rb") as f:
            b = pickle.load(f, encoding="bytes")
        imgs = b[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return imgs, np.asarray(b[b"labels"], np.int32)

    tr_i, tr_l = zip(*[read(f"data_batch_{i}") for i in range(1, 6)])
    te_i, te_l = read("test_batch")
    return (np.concatenate(tr_i), np.concatenate(tr_l), te_i, te_l)


def load_cifar100(root: str):
    d = os.path.join(root, "cifar-100-python")

    def read(name):
        with open(os.path.join(d, name), "rb") as f:
            b = pickle.load(f, encoding="bytes")
        imgs = b[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return imgs, np.asarray(b[b"fine_labels"], np.int32)

    tr_i, tr_l = read("train")
    te_i, te_l = read("test")
    return tr_i, tr_l, te_i, te_l


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def load_fmnist(root: str):
    """FashionMNIST idx files under <root>/FashionMNIST/raw."""
    d = os.path.join(root, "FashionMNIST", "raw")

    def pick(stem):
        for suffix in (".gz", ""):
            p = os.path.join(d, stem + suffix)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(os.path.join(d, stem))

    tr_i = _read_idx(pick("train-images-idx3-ubyte"))[..., None]
    tr_l = _read_idx(pick("train-labels-idx1-ubyte")).astype(np.int32)
    te_i = _read_idx(pick("t10k-images-idx3-ubyte"))[..., None]
    te_l = _read_idx(pick("t10k-labels-idx1-ubyte")).astype(np.int32)
    return tr_i, tr_l, te_i, te_l


def synthetic_array_dataset(labelmap: LabelMap, n: int, size: int = 32,
                            channels: int = 3, seed: int = 0):
    """Class-colored random images (each leaf gets a distinct mean color so
    small models can actually learn) — the fixture stand-in for the
    non-downloadable datasets."""
    rng = np.random.RandomState(seed)
    leaf = rng.randint(0, labelmap.levels[-1], n).astype(np.int32)
    base = rng.randint(0, 255, (labelmap.levels[-1], 1, 1, channels))
    imgs = np.clip(base[leaf] + rng.randint(-40, 40, (n, size, size, channels)),
                   0, 255).astype(np.uint8)
    return ArrayDataset(imgs, leaf, labelmap)


def stratified_index_split(labels: np.ndarray, ratios=(0.8, 0.1, 0.1),
                           seed: int = 0):
    """Per-class 80/10/10 index split (cifar10_set_indices semantics,
    finetuner.py:756-781)."""
    rng = np.random.RandomState(seed)
    tr, va, te = [], [], []
    for c in np.unique(labels):
        idx = np.nonzero(labels == c)[0]
        rng.shuffle(idx)
        n = len(idx)
        n_tr = int(ratios[0] * n)
        n_va = int(ratios[1] * n)
        tr += idx[:n_tr].tolist()
        va += idx[n_tr:n_tr + n_va].tolist()
        te += idx[n_tr + n_va:].tolist()
    return np.asarray(tr), np.asarray(va), np.asarray(te)
