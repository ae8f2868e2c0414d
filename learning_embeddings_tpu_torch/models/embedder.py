"""Label-embedding table and the image-embedding nets: the port of
``learning_embeddings_tpu/models/embedder.py``.

* ``geometry_map``  the per-mode post-map of raw embedding vectors:
  ``euclidean`` (identity, order embeddings), ``euc_cone`` (radial shift
  x̂·(‖x‖+K), so that ‖x‖ ≥ K), ``hyp_cone`` (+1e-15, then the annulus
  projection into [r0, 1 − 1e−5]) and ``hyp_cone_exp0`` (the exp₀-style
  squash, then the annulus projection: the joint trainer's mode).
* ``hyperbolic_init`` N(0, 1) directions at row norms r0 + U[0, 0.05].
* ``LabelEmbedder`` a table (``embedding``, from an explicit generator:
  ``hyperbolic_init`` in the hyperbolic modes, else N(0, 1)) + the
  geometry map.
* ``FeatNet``       the fc7 path's image projector: ``nn.Linear(
  feature_dim, dim)`` named ``fc1`` (flax's initialisers, from an explicit
  generator) → geometry map; under ``hyp_cone_exp0`` the exp₀ squash and
  the annulus clip.
* ``MatrixApproximation``  a low-parameter projector
  x[..., :dim]·diag + (x·v)·u (parameters ``diag`` = 1, ``u`` and ``v`` ~
  N(0, 0.01²)) → geometry map.
* ``FeatCNN``       ResNet trunk (``trunk``) → ``nn.Linear(feature_dim,
  dim)`` named ``fc`` in f32 → geometry map. It takes NCHW images in
  channels_last memory, as ``HierarchicalCNN`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..geometry import exp_map_zero_shifted, inner_radius, project_annulus
from .resnet import BACKBONES, init_params_

__all__ = ["LabelEmbedder", "FeatNet", "MatrixApproximation", "FeatCNN",
           "geometry_map", "hyperbolic_init", "MODES"]

MODES = ("euclidean", "euc_cone", "hyp_cone", "hyp_cone_exp0")
_HYPERBOLIC = ("hyp_cone", "hyp_cone_exp0")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def geometry_map(x: torch.Tensor, mode: str,
                 K: Optional[float]) -> torch.Tensor:
    """Apply the per-mode geometry post-map to raw embedding vectors."""
    _check_mode(mode)
    if mode == "euclidean":
        return x
    if mode == "euc_cone":
        n = torch.sqrt(torch.clamp_min((x * x).sum(-1, keepdim=True), 1e-24))
        return x / n * (n + K)
    r0 = inner_radius(K)
    if mode == "hyp_cone":
        return project_annulus(x + 1e-15, r0)
    return project_annulus(exp_map_zero_shifted(x, r0), r0)


def hyperbolic_init(K: float, generator: Optional[torch.Generator] = None):
    """An init function shape → tensor: N(0, 1) directions scaled to row
    norms inner_radius(K) + U[0, 0.05], drawn from `generator`."""
    r0 = inner_radius(K)

    def init(shape) -> torch.Tensor:
        x = torch.randn(shape, generator=generator)
        n = torch.sqrt(torch.clamp_min((x * x).sum(-1, keepdim=True), 1e-24))
        target = r0 + torch.rand((shape[0], 1), generator=generator) * 0.05
        return x / n * target

    return init


class LabelEmbedder(nn.Module):
    """Embedding table + geometry post-map."""

    def __init__(self, n_nodes: int, dim: int, mode: str = "euclidean",
                 K: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_mode(mode)
        self.mode, self.K = mode, K
        if mode in _HYPERBOLIC:
            table = hyperbolic_init(K, generator)((n_nodes, dim))
        else:
            table = torch.randn((n_nodes, dim), generator=generator)
        self.embedding = nn.Parameter(table)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return geometry_map(self.embedding[ids], self.mode, self.K)


class FeatNet(nn.Module):
    """Image-feature projector fc7 (feature_dim) → dim with the geometry
    post-map."""

    def __init__(self, feature_dim: int, dim: int, mode: str = "euclidean",
                 K: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_mode(mode)
        self.mode, self.K = mode, K
        self.fc1 = nn.Linear(feature_dim, dim)
        init_params_(self, generator)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return geometry_map(self.fc1(feats), self.mode, self.K)


class MatrixApproximation(nn.Module):
    """Image projector W = pad(diag(d)) + u·vᵀ: a diagonal map of the first
    `dim` feature coordinates plus a rank-1 correction over the whole
    feature vector, then the geometry post-map."""

    def __init__(self, feature_dim: int, dim: int, mode: str = "euclidean",
                 K: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_mode(mode)
        self.mode, self.K = mode, K
        self.diag = nn.Parameter(torch.ones(dim))
        self.u = nn.Parameter(0.01 * torch.randn(dim, generator=generator))
        self.v = nn.Parameter(0.01 * torch.randn(feature_dim,
                                                 generator=generator))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        dim = self.diag.shape[0]
        x = feats[..., :dim] * self.diag + (feats @ self.v)[..., None] \
            * self.u
        return geometry_map(x, self.mode, self.K)


class FeatCNN(nn.Module):
    """End-to-end image tower: CNN trunk → dim projection → geometry map.

    The trunk computes in `dtype` with f32 parameters and returns f32
    pooled features; ``fc`` and the geometry map run in f32."""

    def __init__(self, backbone: str, dim: int, mode: str = "euclidean",
                 K: Optional[float] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        _check_mode(mode)
        if backbone not in BACKBONES:
            raise NotImplementedError(
                f"backbone {backbone!r} is not ported yet; ported: "
                f"{sorted(BACKBONES)} (ROADMAP.md queue A item 18)")
        self.mode, self.K = mode, K
        self.trunk = BACKBONES[backbone](dtype=dtype)
        self.fc = nn.Linear(self.trunk.feature_dim, dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return geometry_map(self.fc(self.trunk(images)), self.mode, self.K)
