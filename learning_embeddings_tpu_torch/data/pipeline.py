"""Host input pipeline: the port of ``decode_image``, ``_resize``,
``augment_eval``, ``prefetch_one`` and ``augment_joint_train`` from
``learning_embeddings_tpu/data/pipeline.py`` (lines 30-119).

Images decode with cv2 where it imports, else with PIL, as in the JAX
module; both are imported inside the functions, so importing the package
needs neither. Still to port (ROADMAP.md): ``ImagePipeline``,
``augment_train`` and the native loader.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np

__all__ = ["decode_image", "augment_eval", "augment_joint_train",
           "prefetch_one"]

_PREFETCH_END = object()


@functools.lru_cache(maxsize=None)
def _cv2():
    """The cv2 module, or None where it does not import (then PIL)."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def decode_image(path: str, grayscale: bool = False) -> np.ndarray:
    """HWC uint8, RGB (or HW1 grayscale)."""
    cv2 = _cv2()
    if cv2 is not None:
        flag = cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_COLOR
        img = cv2.imread(path, flag)
        if img is None:
            raise FileNotFoundError(path)
        if grayscale:
            return img[..., None]
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    from PIL import Image

    img = Image.open(path).convert("L" if grayscale else "RGB")
    arr = np.asarray(img)
    return arr[..., None] if grayscale else arr


def _resize(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    cv2 = _cv2()
    if cv2 is not None:
        out = cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)
        return out[..., None] if out.ndim == 2 else out
    from PIL import Image

    out = np.asarray(Image.fromarray(img.squeeze()).resize((hw[1], hw[0])))
    return out[..., None] if out.ndim == 2 else out


def augment_eval(img: np.ndarray, size: int) -> np.ndarray:
    return _resize(img, (size, size))


def augment_joint_train(img: np.ndarray, size: int,
                        rng: np.random.RandomState) -> np.ndarray:
    """resize (S, S) → random hflip: the joint trainers' train transform
    (no crop, unlike the classifier's)."""
    out = _resize(img, (size, size))
    if rng.rand() < 0.5:
        out = out[:, ::-1]
    return out


def prefetch_one(iterable):
    """One-deep pipelined iteration: item k+1 is computed on a background
    thread while the consumer processes item k. Production of consecutive
    items stays serialised (safe for stateful generators, such as samplers
    drawing from one RNG); only production overlaps consumption."""
    it = iter(iterable)
    ex = ThreadPoolExecutor(max_workers=1)
    try:
        fut = ex.submit(next, it, _PREFETCH_END)
        while True:
            item = fut.result()
            if item is _PREFETCH_END:
                return
            fut = ex.submit(next, it, _PREFETCH_END)
            yield item
    finally:
        ex.shutdown(wait=False)
