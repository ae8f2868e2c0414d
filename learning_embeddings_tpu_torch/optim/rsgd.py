"""Riemannian optimization on the Poincaré ball as ``torch.optim`` code: the
port of ``learning_embeddings_tpu/optim/rsgd.py``.

The reference's hyperbolic update is

    grad ← grad · (1 / λ_w)²         with λ_w = 2 / (1 − ‖w‖)
    w    ← exp_map_w(−lr · grad)     (Möbius addition + the ±15 tanh clamp)

* ``RiemannianSGD``   that update. The new point is applied as the delta
  w + (exp_map_w(·) − w), as ``optax.apply_updates`` applies the JAX
  transform's update, which is not bit-equal to assigning the new point.
* ``RiemannianAdam``  Adam moments of the rescaled gradient (componentwise,
  identity transport), optax's bias correction in f32 with the step count
  starting at 1, and the step taken by the same exponential map.
* ``scale_by_conformal_factor_``  grad · (1/λ)² in place, ahead of a stock
  ``torch.optim.Adam`` (or SGD) step: the hybrid path.
* ``project_annulus_``  the post-step projection into [r0, 1 − 1e−5].

Both optimizers keep ``lr`` (and ``K``) in ``param_groups``, so that
``torch.optim.lr_scheduler`` reaches them. Use them only on parameters
that live on the ball (the label table).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from ..geometry import exp_map_x, inner_radius, lambda_x, project_annulus

__all__ = ["RiemannianSGD", "RiemannianAdam", "scale_by_conformal_factor_",
           "project_annulus_"]


def _rescale(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """grad · (1/λ_w)² with the non-squared-norm λ."""
    inv = 1.0 / lambda_x(w)
    return g * (inv * inv)


@torch.no_grad()
def scale_by_conformal_factor_(params: Iterable[torch.Tensor]) -> None:
    """Multiply each parameter's ``.grad`` by (1/λ_w)² in place."""
    for p in params:
        if p.grad is not None:
            p.grad.copy_(_rescale(p.grad, p))


@torch.no_grad()
def project_annulus_(params: Iterable[torch.Tensor], K: float) -> None:
    """Project every row of each parameter into [inner_radius(K), 1−1e−5]
    in place."""
    r0 = inner_radius(K)
    for p in params:
        p.copy_(project_annulus(p, r0))


class _BallOptimizer(torch.optim.Optimizer):
    def __init__(self, params, lr: float, K: float, **defaults):
        if lr < 0:
            raise ValueError(f"invalid learning rate {lr}")
        super().__init__(params, dict(lr=lr, K=K, **defaults))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            r0 = inner_radius(group["K"])
            for p in group["params"]:
                if p.grad is None:
                    continue
                tangent = self._tangent(group, p, _rescale(p.grad, p))
                p.add_(exp_map_x(p, -group["lr"] * tangent, r0) - p)
        return loss


class RiemannianSGD(_BallOptimizer):
    """w ← exp_map_w(−lr · grad·(1/λ_w)²), applied as a delta."""

    def __init__(self, params, lr: float, K: float):
        super().__init__(params, lr, K)

    def _tangent(self, group, p, rgrad):
        return rgrad


class RiemannianAdam(_BallOptimizer):
    """Riemannian Adam (Bécigneul & Ganea, arXiv:1810.00760, in geoopt's
    convention): moments of the rescaled gradient, the step
    exp_map_w(−lr · m̂ / (√v̂ + ε))."""

    def __init__(self, params, lr: float, K: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, lr, K, betas=tuple(betas), eps=eps)

    def _tangent(self, group, p, rgrad):
        b1, b2 = group["betas"]
        state = self.state[p]
        if not state:
            state["step"] = 0
            state["exp_avg"] = torch.zeros_like(p)
            state["exp_avg_sq"] = torch.zeros_like(p)
        state["step"] += 1
        m = b1 * state["exp_avg"] + (1 - b1) * rgrad
        v = b2 * state["exp_avg_sq"] + (1 - b2) * rgrad * rgrad
        state["exp_avg"], state["exp_avg_sq"] = m, v
        # optax's bias correction: 1 − b ** count, in f32
        count = np.float32(state["step"])
        bc1 = float(np.float32(1) - np.float32(b1) ** count)
        bc2 = float(np.float32(1) - np.float32(b2) ** count)
        return (m / bc1) / (torch.sqrt(v / bc2) + group["eps"])
