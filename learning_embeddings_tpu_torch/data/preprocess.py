"""Offline image preprocessing: the port of
``learning_embeddings_tpu/data/preprocess.py`` (the reference's
`data/preprocess_images/crop_images.py`, :7-141), numpy and cv2 only:

* ``contour_crop``  — threshold-sweep contour detection (60→250 step 10)
  with bounding-box plausibility heuristics, used to crop the butterfly
  specimen out of the photographed drawer,
* ``fixed_crop``    — the fallback center-region crop,
* ``preprocess_images`` — threaded crop + resize-to-448 over a directory
  (the reference uses multiprocessing.dummy; cv2 releases the GIL so a
  thread pool saturates cores the same way).

cv2 is imported inside the functions, so the package imports without
it.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["contour_crop", "fixed_crop", "preprocess_images"]


def contour_crop(img: np.ndarray,
                 thresholds: Sequence[int] = tuple(range(60, 251, 10)),
                 min_area_frac: float = 0.02,
                 max_area_frac: float = 0.7,
                 pad_frac: float = 0.05) -> Optional[Tuple[int, int, int, int]]:
    """Best (x, y, w, h) specimen bbox, or None when no plausible contour
    exists at any threshold (the reference then falls back to fixed_crop)."""
    import cv2

    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if img.ndim == 3 else img
    H, W = gray.shape
    area = H * W
    best = None
    best_score = 0.0
    for t in thresholds:
        _, binimg = cv2.threshold(gray, t, 255, cv2.THRESH_BINARY_INV)
        contours, _ = cv2.findContours(binimg, cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        for c in contours:
            x, y, w, h = cv2.boundingRect(c)
            a = w * h
            if not (min_area_frac * area <= a <= max_area_frac * area):
                continue
            # plausibility: roughly centered, not a sliver
            cx, cy = x + w / 2, y + h / 2
            center_score = 1.0 - (abs(cx / W - 0.5) + abs(cy / H - 0.5))
            aspect = min(w, h) / max(w, h)
            score = (a / area) * center_score * aspect
            if score > best_score:
                best_score = score
                best = (x, y, w, h)
    if best is None:
        return None
    x, y, w, h = best
    px, py = int(pad_frac * w), int(pad_frac * h)
    return (max(x - px, 0), max(y - py, 0),
            min(w + 2 * px, W - max(x - px, 0)),
            min(h + 2 * py, H - max(y - py, 0)))


def fixed_crop(img: np.ndarray, frac: float = 0.8) -> Tuple[int, int, int, int]:
    """Centered fixed-fraction crop (the reference's FixedCrop fallback)."""
    H, W = img.shape[:2]
    w, h = int(W * frac), int(H * frac)
    return ((W - w) // 2, (H - h) // 2, w, h)


def _process_one(src: str, dst: str, size: int, use_contour: bool) -> bool:
    import cv2

    img = cv2.imread(src)
    if img is None:
        return False
    box = contour_crop(img) if use_contour else None
    if box is None:
        box = fixed_crop(img)
    x, y, w, h = box
    crop = img[y:y + h, x:x + w]
    out = cv2.resize(crop, (size, size), interpolation=cv2.INTER_AREA)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    cv2.imwrite(dst, out)
    return True


def preprocess_images(src_root: str, dst_root: str, rel_paths: Sequence[str],
                      size: int = 448, use_contour: bool = True,
                      n_workers: int = 8) -> int:
    """Crop+resize every relative path; returns the number processed."""
    with cf.ThreadPoolExecutor(n_workers) as pool:
        results = list(pool.map(
            lambda p: _process_one(os.path.join(src_root, p),
                                   os.path.join(dst_root, p),
                                   size, use_contour),
            rel_paths))
    return int(sum(results))
