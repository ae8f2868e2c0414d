"""All-pairs entailment energies E(U, V): the port of
``learning_embeddings_tpu/geometry/pairwise.py`` (lines 106-167).

* The order energy Σ_d max(0, u_d − v_d)² has no Gram-matrix form: it goes
  to the hand-written kernel of ``ops/pairwise_order.py`` on the card, and
  to its plain version on the CPU.
* The cone energies depend on x·y, ‖x‖ and ‖y‖ only: one ``torch.matmul``
  Gram matrix plus elementwise math, as the JAX package leaves that product
  to XLA.

All functions take U (M, D), V (N, D) and return (M, N) f32.
``pairwise_energy_sharded`` (JAX lines 171-229) tiles the matrix over a
mesh: U's rows shard over 'model', V's over 'data', each rank computes its
(M/p, N/q) tile with the same single-device function (K3 on the card for
the order energy) and the tiles are gathered to every rank.
"""

from __future__ import annotations

import torch

from ..ops.pairwise_order import pairwise_order
from ..parallel.mesh import all_gather_rows
from .energies import EUC_CONE_K, HYP_CONE_K, _CLAMP, _TINY

__all__ = [
    "pairwise_order_energy",
    "pairwise_euc_cone_energy",
    "pairwise_hyp_cone_energy",
    "pairwise_energy",
    "pairwise_energy_sharded",
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


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    if not pad:
        return x
    return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])


def pairwise_energy_sharded(kind: str, u, v, *, mesh=None,
                            **kw) -> torch.Tensor:
    """(M, N) all-pairs energies tiled over `mesh`: U's rows shard over
    'model', V's rows over 'data', so each rank runs the single-device
    function on its (M/p, N/q) tile; the tiles are gathered to every rank
    (all_reduce of zeroed buffers: exact). Ragged M and N pad with a
    repeated last row, and the padding is sliced off. mesh=None, a 1 × 1
    mesh and empty inputs take ``pairwise_energy`` itself. Every entry is
    computed as on one device, so the order kernel's tiles equal its
    whole matrix bit for bit."""
    m, n = int(u.shape[0]), int(v.shape[0])
    if mesh is None or m == 0 or n == 0 or mesh.size == 1:
        return pairwise_energy(kind, u, v, **kw)
    p, q = mesh.n_model, mesh.n_data
    up, vp = _pad_rows(u, p), _pad_rows(v, q)
    mb, nb = up.shape[0] // p, vp.shape[0] // q
    i, j = mesh.model_index, mesh.data_index
    tile = pairwise_energy(kind, up[i * mb:(i + 1) * mb],
                           vp[j * nb:(j + 1) * nb], **kw)       # (mb, nb)
    rows = all_gather_rows(tile.T.contiguous(), mesh.data_group,
                           "pairwise_tiles").T                  # (mb, N')
    return all_gather_rows(rows.contiguous(), mesh.model_group,
                           "pairwise_tiles")[:m, :n]
