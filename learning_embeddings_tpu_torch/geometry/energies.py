"""Entailment energy operators E(u, v): the port of
``learning_embeddings_tpu/geometry/energies.py``.

Same three energies over the last axis (batch dimensions broadcast), same
floors and clamps, computed in f32:

* ``order_energy``     ‖max(0, u − v)‖²
* ``euc_cone_energy``  max(0, Θ(x, y) − ψ(x)), Θ = −⟨x̂, (y−x)̂⟩,
  ψ = −sqrt(1 − K²/‖x‖²), K = 3.0
* ``hyp_cone_energy``  the Poincaré-ball cone energy with the reference's
  ±(1 − 1e−5) acos/asin clamps, K = 0.1

Denominators are floored at 1e-15 (norms in ``_normalize`` at 1e-12, as
torch's ``F.normalize``), so only exactly degenerate pairs are affected.
One difference from the JAX package: norms are taken as sqrt(max(Σx²,
1e-30)), so that two coincident embeddings (the same image twice) give the
cone energies a gradient of 0, where the JAX package's is NaN.
"""

from __future__ import annotations

import torch

__all__ = [
    "order_energy",
    "euc_cone_energy",
    "hyp_cone_energy",
    "EUC_CONE_K",
    "HYP_CONE_K",
    "inner_radius",
]

EUC_CONE_K = 3.0
HYP_CONE_K = 0.1
_TINY = 1e-15
_CLAMP = 1e-5      # the reference's acos/asin argument clamp offset


def inner_radius(K: float) -> float:
    """Minimum-norm annulus radius for cone embeddings:
    2K / (1 + sqrt(1 + 4K²))."""
    return 2.0 * K / (1.0 + (1.0 + 4.0 * K * K) ** 0.5)


def order_energy(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """E(u, v) = ‖max(0, u − v)‖², zero iff v dominates u coordinatewise."""
    d = torch.clamp_min(x.float() - y.float(), 0.0)
    return (d * d).sum(-1)


def _norm(x, keepdim=False):
    # the square is floored at 1e-30 (a norm of 1e-15, under every floor
    # below): a value that only the floors below see, and a gradient of 0
    # instead of NaN (0 · ∞) where x is 0, as ‖x − y‖ of two coincident
    # embeddings is (duplicate images)
    return torch.sqrt(torch.clamp_min((x * x).sum(-1, keepdim=keepdim),
                                      1e-30))


def _normalize(x):
    """L2 normalise along the last axis, norm floored at 1e-12."""
    return x / torch.clamp_min(_norm(x, keepdim=True), 1e-12)


def euc_cone_energy(x: torch.Tensor, y: torch.Tensor,
                    K: float = EUC_CONE_K) -> torch.Tensor:
    """Euclidean cones in cos space: E = max(0, Θ − ψ)."""
    x = x.float()
    y = y.float()
    theta = -(_normalize(x) * _normalize(y - x)).sum(-1)
    x_norm_sq = torch.clamp_min((x * x).sum(-1), _TINY)
    # the sqrt argument is clamped at 0 so float error cannot give NaN
    psi = -torch.sqrt(torch.clamp_min(1.0 - (K * K) / x_norm_sq, 0.0))
    return torch.clamp_min(theta - psi, 0.0)


def hyp_cone_energy(x: torch.Tensor, y: torch.Tensor,
                    K: float = HYP_CONE_K) -> torch.Tensor:
    """Hyperbolic cones in angle space (radians): E = max(0, Ξ − ψ),

    Ξ(x,y) = acos[(⟨x,y⟩(1+‖x‖²) − ‖x‖²(1+‖y‖²)) /
                  (‖x‖ · ‖x−y‖ · sqrt(1 + ‖x‖²‖y‖² − 2⟨x,y⟩))]
    ψ(x)   = asin(K(1−‖x‖²)/‖x‖)."""
    x = x.float()
    y = y.float()
    x_norm = _norm(x)
    y_norm = _norm(y)
    x_y_dist = _norm(x - y)
    x_dot_y = (x * y).sum(-1)

    num = x_dot_y * (1.0 + x_norm**2) - (x_norm**2) * (1.0 + y_norm**2)
    rad = torch.clamp_min(1.0 + (x_norm * y_norm) ** 2 - 2.0 * x_dot_y,
                          _TINY)
    den = torch.clamp_min(x_norm * x_y_dist * torch.sqrt(rad), _TINY)
    theta = torch.arccos(torch.clamp(num / den, -1.0 + _CLAMP, 1.0 - _CLAMP))
    psi_arg = K * (1.0 - x_norm**2) / torch.clamp_min(x_norm, _TINY)
    psi = torch.arcsin(torch.clamp(psi_arg, -1.0 + _CLAMP, 1.0 - _CLAMP))
    return torch.clamp_min(theta - psi, 0.0)
