"""The plain reference of the hierarchical classifier: the first train
steps (ResNet-50 with train-mode BatchNorm, the multi-head linear layer,
``multi_level_ce`` and Adam) and the eval-mode scores, in float32.

Its inputs are what the benchmark made: the seeded weights and the host
batches. It returns what the check compares: each step's loss, the norm
of each leaf's first gradient and of each leaf's change after the steps.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .resnet import (Adam, features, float32_math, head, identity,
                     multi_level_ce, scale_images, trainable)


def train_steps(params0: Dict[str, torch.Tensor],
                batches: Sequence[Tuple[np.ndarray, np.ndarray]],
                levels: Sequence[int], lr: float, device,
                q: Callable = identity) -> dict:
    """Follows len(batches) Adam steps from `params0` on (uint8 NHWC
    images, level labels) batches. Returns {"losses", "grad_norms" (of the
    first step), "change_norms"} keyed by leaf name."""
    with float32_math():
        start = {k: v.to(device, torch.float32) for k, v in params0.items()}
        p = {k: v.clone() for k, v in start.items()}
        names = [k for k in p if trainable(k)]
        adam = Adam({k: lr for k in names})
        losses: List[float] = []
        grad_norms = None
        for images, level_labels in batches:
            for k in names:
                p[k] = p[k].detach().requires_grad_(True)
            x = scale_images(torch.as_tensor(images).to(device))
            ll = torch.as_tensor(np.asarray(level_labels), dtype=torch.int64,
                                 device=device)
            feats = features(p, x, True, q, recompute=True)
            loss = multi_level_ce(head(p, feats), ll, levels)
            grads = torch.autograd.grad(loss, [p[k] for k in names])
            for k in names:
                p[k] = p[k].detach()
            if grad_norms is None:
                grad_norms = {k: float(g.norm()) for k, g in zip(names, grads)}
            adam.step(p, dict(zip(names, grads)))
            losses.append(float(loss.detach()))
            del x, feats, loss, grads
        change = {k: float((p[k] - start[k]).norm()) for k in names}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


@torch.no_grad()
def eval_scores(params: Dict[str, torch.Tensor], images: np.ndarray,
                device, q: Callable = identity, block: int = 64) -> np.ndarray:
    """Eval-mode logits (N, n_classes) of uint8 NHWC images, `block` rows
    at a time (eval-mode BatchNorm treats each row alone)."""
    with float32_math():
        p = {k: v.to(device, torch.float32) for k, v in params.items()}
        out = []
        for i in range(0, len(images), block):
            x = scale_images(torch.as_tensor(images[i:i + block]).to(device))
            out.append(head(p, features(p, x, False, q)).cpu().numpy())
    return np.concatenate(out)
