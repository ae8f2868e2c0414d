"""All-pairs entailment energies E(U, V): the port of
``learning_embeddings_tpu/geometry/pairwise.py`` (lines 106-167).

* The order energy Σ_d max(0, u_d − v_d)² has no Gram-matrix form: it goes
  to the hand-written kernel of ``ops/pairwise_order.py`` on the card, and
  to its plain version on the CPU.
* The cone energies depend on x·y, ‖x‖ and ‖y‖ only: one ``torch.matmul``
  Gram matrix plus elementwise math, as the JAX package leaves that product
  to XLA.

All functions take U (M, D), V (N, D) and return (M, N) f32. There is no
mesh here and so no ``pairwise_energy_sharded`` (ROADMAP.md queue A
item 21).
"""

from __future__ import annotations

import torch

from ..ops.pairwise_order import pairwise_order
from .energies import EUC_CONE_K, HYP_CONE_K, _CLAMP, _TINY

__all__ = [
    "pairwise_order_energy",
    "pairwise_euc_cone_energy",
    "pairwise_hyp_cone_energy",
    "pairwise_energy",
]


def pairwise_order_energy(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(M, N) matrix of order energies E(u_i, v_j) = ‖max(0, u_i − v_j)‖²."""
    return pairwise_order(u, v)


def _gram_stats(u, v):
    u = u.float()
    v = v.float()
    dot = torch.matmul(u, v.T)                                        # (M, N)
    un = torch.sqrt(torch.clamp_min((u * u).sum(-1), 0.0))[:, None]  # (M, 1)
    vn = torch.sqrt(torch.clamp_min((v * v).sum(-1), 0.0))[None, :]  # (1, N)
    # cancellation-stable: ‖x−y‖² = (‖x‖−‖y‖)² + 2(‖x‖‖y‖ − x·y)
    c = torch.clamp_min(un * vn - dot, 0.0)
    dist = torch.sqrt((un - vn) ** 2 + 2.0 * c)
    return dot, un, vn, dist


def pairwise_euc_cone_energy(u, v, K: float = EUC_CONE_K) -> torch.Tensor:
    """Pairwise Euclidean cone energy from the Gram matrix:
    Θ = −(x·y − ‖x‖²) / (‖x‖·‖y−x‖), norms floored at 1e-12;
    ψ = −sqrt(1 − K²/‖x‖²)."""
    dot, un, vn, dist = _gram_stats(u, v)
    theta = -(dot - un**2) / (torch.clamp_min(un, 1e-12)
                              * torch.clamp_min(dist, 1e-12))
    psi = -torch.sqrt(torch.clamp_min(
        1.0 - (K * K) / torch.clamp_min(un**2, _TINY), 0.0))
    return torch.clamp_min(theta - psi, 0.0)


def pairwise_hyp_cone_energy(u, v, K: float = HYP_CONE_K) -> torch.Tensor:
    """Pairwise hyperbolic cone energy from the Gram matrix (the formula
    and ±(1−1e−5) clamps of energies.hyp_cone_energy)."""
    dot, un, vn, dist = _gram_stats(u, v)
    num = dot * (1.0 + un**2) - (un**2) * (1.0 + vn**2)
    # stable: 1 + (‖x‖‖y‖)² − 2x·y = (1 − ‖x‖‖y‖)² + 2(‖x‖‖y‖ − x·y)
    rad = torch.clamp_min(
        (1.0 - un * vn) ** 2 + 2.0 * torch.clamp_min(un * vn - dot, 0.0),
        _TINY)
    den = torch.clamp_min(un * dist * torch.sqrt(rad), _TINY)
    theta = torch.arccos(torch.clamp(num / den, -1.0 + _CLAMP, 1.0 - _CLAMP))
    psi_arg = K * (1.0 - un**2) / torch.clamp_min(un, _TINY)
    psi = torch.arcsin(torch.clamp(psi_arg, -1.0 + _CLAMP, 1.0 - _CLAMP))
    return torch.clamp_min(theta - psi, 0.0)


_PAIRWISE = {
    "order": pairwise_order_energy,
    "euc_cone": pairwise_euc_cone_energy,
    "hyp_cone": pairwise_hyp_cone_energy,
}


def pairwise_energy(kind: str, u, v, **kw) -> torch.Tensor:
    return _PAIRWISE[kind](u, v, **kw)
