"""LIME for images, from scratch (no `lime`/`skimage`): the port's copy of
``learning_embeddings_tpu/viz/lime.py`` (pure numpy, the same code).

Counterpart of the reference's `lime_image.explain_instance` usage in
`network/inference.py:248-362`: segment the image into superpixels, sample
random segment-occlusion masks, score them with the classifier, and fit a
locally-weighted ridge surrogate whose coefficients rank segments per class.

Components:
* :func:`slic_segments` — SLIC superpixels (k-means in (lab-ish color, xy)
  space), the same family of segmenter LIME defaults to.
* :func:`lime_explain` — the LIME core: perturbation sampling with
  ``hide_color`` fill, exponential cosine-distance kernel, per-class
  weighted ridge regression (closed form). ``predict_fn`` takes and
  returns numpy; ``cli/inference.py`` hands it one that runs the model on
  the card.
* :func:`mark_boundaries` / :func:`overlay_mask` — render the reference's
  `get_image_and_mask(positive_only=False, num_features=10)` +
  `mark_boundaries` output: green boundaries on positively-weighted
  segments, red on negatively-weighted ones.
"""

from __future__ import annotations

import numpy as np

# pixel-count x center-count threshold above which the SLIC assignment
# switches to the chunked distance path (patchable in tests)
_DENSE_LIMIT = 4_000_000


def slic_segments(image: np.ndarray, n_segments: int = 64,
                  compactness: float = 0.2, n_iter: int = 10) -> np.ndarray:
    """SLIC superpixels. `image` is (H, W, C) float; returns (H, W) int32
    labels in [0, n_labels) with every label non-empty.

    K-means over (color, compactness-scaled xy) features with grid-seeded
    centers, each pixel assigned within a 2S window of its nearest centers
    (implemented as a full assignment over centers for simplicity — the
    images here are <=448² and this is an offline analysis tool).
    """
    H, W = image.shape[:2]
    C = image.reshape(H, W, -1).astype(np.float32)
    n_segments = max(1, min(n_segments, H * W))
    # grid seeding
    step = max(1, int(np.sqrt(H * W / n_segments)))
    ys = np.arange(step // 2, H, step)
    xs = np.arange(step // 2, W, step)
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    cy, cx = cy.ravel().astype(np.float32), cx.ravel().astype(np.float32)

    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    # feature = [color..., compactness * y/step, compactness * x/step]
    scale = compactness
    feats = np.concatenate(
        [C.reshape(H * W, -1),
         (yy.reshape(-1, 1) / step) * scale,
         (xx.reshape(-1, 1) / step) * scale], axis=1)

    centers = np.concatenate(
        [C[cy.astype(int), cx.astype(int)].reshape(len(cy), -1),
         (cy.reshape(-1, 1) / step) * scale,
         (cx.reshape(-1, 1) / step) * scale], axis=1)

    labels = np.zeros(H * W, np.int32)
    for _ in range(n_iter):
        # full pairwise distances (N_pix x N_centers); fine at this scale
        d = ((feats[:, None, :] - centers[None, :, :]) ** 2).sum(-1) \
            if feats.shape[0] * centers.shape[0] <= _DENSE_LIMIT else None
        if d is None:  # chunk over pixels for big images
            d = np.empty((feats.shape[0], centers.shape[0]), np.float32)
            for s in range(0, feats.shape[0], 65536):
                d[s:s + 65536] = ((feats[s:s + 65536, None, :] -
                                   centers[None, :, :]) ** 2).sum(-1)
        labels = d.argmin(1).astype(np.int32)
        for k in range(centers.shape[0]):
            sel = labels == k
            if sel.any():
                centers[k] = feats[sel].mean(0)
    # relabel to consecutive non-empty ids
    uniq, labels = np.unique(labels, return_inverse=True)
    return labels.reshape(H, W).astype(np.int32)


def lime_explain(image: np.ndarray, predict_fn, segments: np.ndarray,
                 num_samples: int = 100, hide_color: float = 0.0,
                 kernel_width: float = 0.25, ridge_alpha: float = 1.0,
                 batch_size: int = 32,
                 rng: np.random.RandomState | None = None):
    """LIME core. `predict_fn(images: (B,H,W,C)) -> (B, n_classes)` probs.

    Returns `(coefs, probs0)`: per-class segment weights `(n_classes,
    n_segments)` from a distance-kernel-weighted ridge fit, and the model's
    probabilities on the unperturbed image (masks[0] is all-on, as in lime).
    """
    rng = rng or np.random.RandomState(0)
    S = int(segments.max()) + 1
    masks = (rng.rand(num_samples, S) > 0.5).astype(np.float32)
    masks[0] = 1.0

    seg_flat = segments.reshape(-1)
    imgs = np.empty((num_samples,) + image.shape, image.dtype)
    flat = image.reshape(-1, image.shape[-1])
    for i in range(num_samples):
        keep = masks[i][seg_flat] > 0            # (H*W,)
        out = np.where(keep[:, None], flat, np.asarray(hide_color,
                                                       image.dtype))
        imgs[i] = out.reshape(image.shape)

    probs = []
    for s in range(0, num_samples, batch_size):
        chunk = imgs[s:s + batch_size]
        pad = batch_size - len(chunk)            # fixed shape: one compile
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        probs.append(np.asarray(predict_fn(chunk))[:batch_size - pad
                                                   if pad else batch_size])
    probs = np.concatenate(probs)                # (num_samples, n_classes)

    # lime's kernel: exp(-(cosine distance to the all-on mask)^2 / kw^2)
    ones = np.ones(S, np.float32)
    cos = masks @ ones / (np.linalg.norm(masks, axis=1)
                          * np.linalg.norm(ones) + 1e-12)
    dist = 1.0 - cos
    w = np.exp(-(dist ** 2) / kernel_width ** 2)

    # weighted ridge, closed form, one solve for all classes at once:
    # beta = (Z^T W Z + alpha I)^-1 Z^T W Y
    Zw = masks * w[:, None]
    A = masks.T @ Zw + ridge_alpha * np.eye(S, dtype=np.float64)
    B = Zw.T @ probs
    coefs = np.linalg.solve(A, B).T.astype(np.float32)  # (n_classes, S)
    return coefs, probs[0]


def top_feature_mask(coefs_c: np.ndarray, segments: np.ndarray,
                     num_features: int = 10,
                     positive_only: bool = False) -> np.ndarray:
    """Reference `get_image_and_mask` semantics: pick the `num_features`
    segments with the largest |weight| (or largest weight if
    positive_only); return an (H, W) int8 mask with +1 on positive
    segments, -1 on negative ones, 0 elsewhere."""
    order = (np.argsort(-coefs_c) if positive_only
             else np.argsort(-np.abs(coefs_c)))[:num_features]
    mask = np.zeros(segments.shape, np.int8)
    for k in order:
        if positive_only and coefs_c[k] <= 0:
            continue
        mask[segments == k] = 1 if coefs_c[k] > 0 else -1
    return mask


def _boundaries(labels: np.ndarray) -> np.ndarray:
    """(H, W) bool — pixels whose right/down neighbor has another label."""
    b = np.zeros(labels.shape, bool)
    b[:, :-1] |= labels[:, :-1] != labels[:, 1:]
    b[:-1, :] |= labels[:-1, :] != labels[1:, :]
    return b


def mark_boundaries(image01: np.ndarray, segments: np.ndarray,
                    color=(1.0, 1.0, 0.0)) -> np.ndarray:
    """skimage.mark_boundaries stand-in: draw segment boundaries in
    `color` over a [0,1] RGB image."""
    out = np.array(image01, np.float32, copy=True)
    if out.ndim == 2:
        out = np.repeat(out[..., None], 3, -1)
    if out.shape[-1] == 1:
        out = np.repeat(out, 3, -1)
    out[_boundaries(segments)] = color
    return np.clip(out, 0, 1)


def overlay_mask(image01: np.ndarray, segments: np.ndarray,
                 mask: np.ndarray) -> np.ndarray:
    """Render an explanation: green boundaries around +1 segments, red
    around -1 segments, faint segment grid elsewhere."""
    out = mark_boundaries(image01, segments, color=(0.8, 0.8, 0.8))
    pos = _boundaries(segments) & (mask > 0)
    neg = _boundaries(segments) & (mask < 0)
    out[pos] = (0.0, 1.0, 0.0)
    out[neg] = (1.0, 0.0, 0.0)
    return out
