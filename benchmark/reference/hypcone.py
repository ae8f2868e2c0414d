"""The plain reference of the joint image + label step with hyperbolic
entailment cones (Ganea et al., arXiv:1804.01882; Dhall et al.,
arXiv:2004.03459), in float32.

* Poincaré-ball geometry with the original code's numerics: norms as
  sqrt(max(Σx², 1e-30)); the annulus [r0, 1 − 1e−5] with r0 =
  2K / (1 + sqrt(1 + 4K²)), the projection's scale carrying no gradient;
  the exp₀-style map tanh(atanh(r0) + ‖x‖)·x̂ (x offset by 1e-15, the
  tanh argument clamped at ±15) that both the label rows and the image
  tower's outputs go through, then the annulus projection.
* The cone energy E(x, y) = max(0, Ξ(x, y) − ψ(x)) with the acos / asin
  arguments clamped to ±(1 − 1e−5) and denominators floored at 1e-15.
* The margin loss Σ E⁺ + Σ max(0, α − E⁻), summed over the batch.
* The hybrid label update: the table's gradient times (1/λ)², λ = 2 /
  (1 − ‖w‖) with the non-squared norm, one Adam step shared with the
  tower (its own learning rate), then the table projected into the
  annulus.
* The tower: ``resnet.features`` in train mode over the step's unique
  images, padded to a multiple of the bucket by repeating rows from the
  start (the repeats enter the BatchNorm statistics), then a linear
  projection to the embedding.

The negatives come from ``sampler.py``, a frozen copy of the host
sampler, drawn from the same ``RandomState`` as the measured trainer's.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .resnet import Adam, features, float32_math, identity, scale_images
from .sampler import sample_joint_negatives_np

_TINY = 1e-15
_CLAMP = 1e-5
#: the label table's leaf name in the check's readings
LABELS = "labels"


def inner_radius(K: float) -> float:
    return 2.0 * K / (1.0 + (1.0 + 4.0 * K * K) ** 0.5)


def _norm(x, keepdim=False):
    return torch.sqrt(torch.clamp_min((x * x).sum(-1, keepdim=keepdim),
                                      1e-30))


def project_annulus(x, r0, eps=_CLAMP):
    n = _norm(x, keepdim=True)
    scale = torch.where(n <= r0, r0 / n,
                        torch.where(n >= 1.0, (1.0 - eps) / n, 1.0))
    return x * scale.detach()


def _atanh_f32(r: float) -> float:
    t = torch.clamp(torch.tensor(r, dtype=torch.float32), -1 + _CLAMP,
                    1 - _CLAMP)
    return float(0.5 * (torch.log1p(t) - torch.log1p(-t)))


def embed(x, K):
    """Raw rows → points of the annulus (the label rows' and the tower's
    post-map)."""
    r0 = inner_radius(K)
    x = x + 1e-15
    n = _norm(x, keepdim=True)
    scale = torch.tanh(torch.clamp(_atanh_f32(r0) + n, -15.0, 15.0))
    return project_annulus(scale * x / torch.clamp_min(n, 1e-12), r0)


def cone_energy(x, y, K):
    x_norm, y_norm = _norm(x), _norm(y)
    dist = _norm(x - y)
    dot = (x * y).sum(-1)
    num = dot * (1.0 + x_norm ** 2) - x_norm ** 2 * (1.0 + y_norm ** 2)
    rad = torch.clamp_min(1.0 + (x_norm * y_norm) ** 2 - 2.0 * dot, _TINY)
    den = torch.clamp_min(x_norm * dist * torch.sqrt(rad), _TINY)
    theta = torch.arccos(torch.clamp(num / den, -1 + _CLAMP, 1 - _CLAMP))
    psi_arg = K * (1.0 - x_norm ** 2) / torch.clamp_min(x_norm, _TINY)
    psi = torch.arcsin(torch.clamp(psi_arg, -1 + _CLAMP, 1 - _CLAMP))
    return torch.clamp_min(theta - psi, 0.0)


def conformal_scale(g, w):
    """g · (1/λ_w)², λ_w = 2 / (1 − ‖w‖)."""
    inv = (1.0 - _norm(w, keepdim=True)) / 2.0
    return g * inv * inv


def unique_images(ids: np.ndarray, n_labels: int, bucket: int):
    """(sorted unique image rows, the rows padded to a multiple of
    `bucket` by repeating from the start)."""
    rows = np.unique(ids[ids >= n_labels]) - n_labels
    if len(rows) == 0:
        rows = np.zeros((1,), np.int64)
    return rows, np.resize(rows, -(-len(rows) // bucket) * bucket)


def joint_steps(tower0: Dict[str, torch.Tensor], table0: torch.Tensor,
                graph, edges: Sequence[Tuple[np.ndarray, np.ndarray]],
                rng: np.random.RandomState, bank: np.ndarray, device, *,
                K: float, alpha: float, neg_to_pos_ratio: int,
                lr_labels: float, lr_images: float, bucket: int,
                q: Callable = identity) -> dict:
    """Follows one step per (pos_from, pos_to) of `edges`, drawing each
    step's negatives from `rng`; image row r reads bank[r mod len(bank)].
    Returns {"losses", "grad_norms" (as the optimizer gets them at the
    first step), "change_norms", "label_change" (the table's change, a
    tensor), "label_rms" (each of its entries' RMS gradient over the
    steps), "negatives" [(neg_from, neg_to)]}."""
    nl = graph.n_labels
    r0 = inner_radius(K)
    with float32_math():
        start = {k: v.to(device, torch.float32)
                 for k, v in tower0.items()}
        start[LABELS] = table0.to(device, torch.float32)
        p = {k: v.clone() for k, v in start.items()}
        names = [k for k in p if not k.endswith(("running_mean",
                                                 "running_var"))]
        adam = Adam({k: lr_labels if k == LABELS else lr_images
                     for k in names})
        losses: List[float] = []
        negatives = []
        grad_norms = None
        for pos_from, pos_to in edges:
            nf, nt = sample_joint_negatives_np(graph, neg_to_pos_ratio, rng,
                                               pos_from, pos_to)
            negatives.append((nf, nt))
            ids = np.concatenate([pos_from, pos_to, nf, nt]).astype(np.int64)
            rows, padded = unique_images(ids, nl, bucket)
            for k in names:
                p[k] = p[k].detach().requires_grad_(True)
            x = scale_images(torch.as_tensor(bank[padded % len(bank)])
                             .to(device))
            img = embed(F.linear(features(p, x, True, q, recompute=True),
                                 p["fc.weight"], p["fc.bias"]), K)

            def emb(a):
                a = np.asarray(a, np.int64)
                slot = np.searchsorted(rows, np.maximum(a - nl, 0))
                slot = np.minimum(slot, len(rows) - 1)
                is_img = torch.as_tensor(a >= nl, device=device)[:, None]
                lab = embed(p[LABELS][torch.as_tensor(
                    np.minimum(a, nl - 1), device=device)], K)
                return torch.where(is_img, img[torch.as_tensor(
                    slot, device=device)], lab)

            e_pos = cone_energy(emb(pos_from), emb(pos_to), K)
            e_neg = cone_energy(emb(nf), emb(nt), K)
            loss = e_pos.sum() + torch.clamp_min(alpha - e_neg, 0.0).sum()
            grads = dict(zip(names, torch.autograd.grad(
                loss, [p[k] for k in names])))
            for k in names:
                p[k] = p[k].detach()
            grads[LABELS] = conformal_scale(grads[LABELS], p[LABELS])
            if grad_norms is None:
                grad_norms = {k: float(g.norm()) for k, g in grads.items()}
            adam.step(p, grads)
            p[LABELS] = project_annulus(p[LABELS], r0)
            losses.append(float(loss.detach()))
            del x, img, loss, grads
        change = {k: float((p[k] - start[k]).norm()) for k in names}
        label_change = (p[LABELS] - start[LABELS]).cpu()
        # each table entry's RMS gradient over the steps
        label_rms = torch.sqrt(adam.v[LABELS]
                               / (1 - adam.b2 ** adam.t)).cpu()
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "label_change": label_change,
            "label_rms": label_rms, "negatives": negatives}
