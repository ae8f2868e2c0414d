"""Label-embedding table and the end-to-end image tower: the port of
``learning_embeddings_tpu/models/embedder.py`` (lines 44-89, 129-153).

* ``geometry_map``  the per-mode post-map of raw embedding vectors:
  ``euclidean`` (identity, order embeddings), ``euc_cone`` (radial shift
  x̂·(‖x‖+K), so that ‖x‖ ≥ K), ``hyp_cone`` (+1e-15, then the annulus
  projection into [r0, 1 − 1e−5]) and ``hyp_cone_exp0`` (the exp₀-style
  squash, then the annulus projection: the joint trainer's mode).
* ``hyperbolic_init`` N(0, 1) directions at row norms r0 + U[0, 0.05].
* ``LabelEmbedder`` a table (``embedding``, from an explicit generator:
  ``hyperbolic_init`` in the hyperbolic modes, else N(0, 1)) + the
  geometry map.
* ``FeatCNN``       ResNet trunk (``trunk``) → ``nn.Linear(feature_dim,
  dim)`` named ``fc`` in f32 → geometry map. It takes NCHW images in
  channels_last memory, as ``HierarchicalCNN`` does.

``FeatNet`` and ``MatrixApproximation`` (the fc7 path) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..geometry import exp_map_zero_shifted, inner_radius, project_annulus
from .resnet import BACKBONES

__all__ = ["LabelEmbedder", "FeatCNN", "geometry_map", "hyperbolic_init",
           "MODES"]

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
