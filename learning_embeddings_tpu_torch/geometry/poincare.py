"""Poincaré-ball operations: the port of
``learning_embeddings_tpu/geometry/poincare.py``, with the same numerics,
which are the reference's and not bugs:

* ``lambda_x`` is 2 / (1 − ‖x‖), with the *non-squared* norm;
* ``exp_map_x`` clamps the tanh argument at ±15 and offsets v by 1e-15;
* ``mobius_add`` offsets v by ``v_offset`` (1e-6 by default) and projects
  its result into the annulus;
* ``project_annulus`` rescales rows with ‖x‖ ≤ r0 up to r0 and rows with
  ‖x‖ ≥ 1 down to 1 − 1e−5; the scale carries no gradient;
* ``_norm`` is floored at 1e-30, and ``exp_map_zero_shifted`` divides by
  its norm floored at 1e-12, as ``F.normalize`` does.

All functions work on the last axis and broadcast over the others.
"""

from __future__ import annotations

import functools

import torch

from .energies import inner_radius

__all__ = [
    "arctanh",
    "project_annulus",
    "mobius_add",
    "lambda_x",
    "exp_map_x",
    "exp_map_zero_shifted",
    "poincare_distance",
    "inner_radius",
]

_TANH_CLAMP = 15.0
_EPS = 1e-5


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min((x * x).sum(-1, keepdim=True), 1e-30))


def arctanh(x: torch.Tensor) -> torch.Tensor:
    """atanh with the input clamped to ±(1 − 1e−5)."""
    x = torch.clamp(x, -1.0 + _EPS, 1.0 - _EPS)
    return 0.5 * (torch.log1p(x) - torch.log1p(-x))


def project_annulus(x: torch.Tensor, radius_min: float,
                    eps: float = _EPS) -> torch.Tensor:
    """Rescale rows into the annulus [radius_min, 1 − eps]; the scale is
    detached, so the backward pass sees a constant rescaling."""
    n = _norm(x)
    scale = torch.where(n <= radius_min, radius_min / n,
                        torch.where(n >= 1.0, (1.0 - eps) / n, 1.0))
    return x * scale.detach()


def mobius_add(u: torch.Tensor, v: torch.Tensor, radius_min: float,
               v_offset: float = 1e-6) -> torch.Tensor:
    """Möbius addition u ⊕ v followed by the annulus projection:

    ((1 + 2⟨u,v⟩ + ‖v‖²) u + (1 − ‖u‖²) v) / (1 + 2⟨u,v⟩ + ‖u‖²‖v‖²)."""
    v = v + v_offset
    dot2 = 2.0 * (u * v).sum(-1, keepdim=True)
    nu = (u * u).sum(-1, keepdim=True)
    nv = (v * v).sum(-1, keepdim=True)
    den = 1.0 + dot2 + nv * nu
    out = (1.0 + dot2 + nv) / den * u + (1.0 - nu) / den * v
    return project_annulus(out, radius_min)


def lambda_x(x: torch.Tensor) -> torch.Tensor:
    """The conformal factor 2 / (1 − ‖x‖), non-squared norm; (..., 1)."""
    return 2.0 / (1.0 - _norm(x))


def exp_map_x(x: torch.Tensor, v: torch.Tensor, radius_min: float,
              v_offset: float = 1e-6) -> torch.Tensor:
    """Exponential map at x of the tangent v:
    x ⊕ (tanh(clamp(λ_x ‖v‖ / 2, ±15)) · v / ‖v‖)."""
    v = v + 1e-15
    nv = _norm(v)
    second = torch.tanh(torch.clamp(lambda_x(x) * nv / 2.0, -_TANH_CLAMP,
                                    _TANH_CLAMP)) * v / nv
    return mobius_add(x, second, radius_min, v_offset=v_offset)


@functools.lru_cache(maxsize=None)
def _arctanh_scalar(r: float, dtype: torch.dtype) -> float:
    """arctanh(r) computed once on the CPU in `dtype`: a Python number
    that the device kernels take as an argument, so that no step copies a
    scalar to the card (a blocking copy)."""
    return float(arctanh(torch.tensor(r, dtype=dtype)))


def exp_map_zero_shifted(x: torch.Tensor, radius_min: float) -> torch.Tensor:
    """tanh(clamp(atanh(r0) + ‖x‖, ±15)) · x̂: maps any vector into the
    ball at norm ≥ r0 (the hyperbolic label table's and image tower's
    post-map in the joint trainer)."""
    x = x + 1e-15
    n = _norm(x)
    r0_h = _arctanh_scalar(float(radius_min), x.dtype)
    scale = torch.tanh(torch.clamp(r0_h + n, -_TANH_CLAMP, _TANH_CLAMP))
    return scale * x / torch.clamp_min(n, 1e-12)


def poincare_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """d(x, y) = arccosh(1 + 2‖x−y‖² / ((1−‖x‖²)(1−‖y‖²))); used by no loss,
    kept for analysis."""
    sq = ((x - y) ** 2).sum(-1)
    nx = (x * x).sum(-1)
    ny = (y * y).sum(-1)
    arg = 1.0 + 2.0 * sq / torch.clamp_min((1.0 - nx) * (1.0 - ny), 1e-15)
    return torch.arccosh(torch.clamp_min(arg, 1.0))
