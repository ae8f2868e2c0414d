"""Label-embedding table and the end-to-end image tower: the port of
``learning_embeddings_tpu/models/embedder.py`` (lines 44-89, 129-153).

* ``geometry_map``  the per-mode post-map of raw embedding vectors:
  ``euclidean`` (identity, order embeddings) and ``euc_cone`` (radial
  shift x̂·(‖x‖+K), so that ‖x‖ ≥ K). The hyperbolic modes wait for the
  port of ``geometry/poincare.py`` (ROADMAP.md queue A item 11) and raise.
* ``LabelEmbedder`` a table (``embedding``, N(0, 1) from an explicit
  generator) + the geometry map.
* ``FeatCNN``       ResNet trunk (``trunk``) → ``nn.Linear(feature_dim,
  dim)`` named ``fc`` in f32 → geometry map. It takes NCHW images in
  channels_last memory, as ``HierarchicalCNN`` does.

``FeatNet`` and ``MatrixApproximation`` (the fc7 path) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .resnet import BACKBONES

__all__ = ["LabelEmbedder", "FeatCNN", "geometry_map", "MODES"]

MODES = ("euclidean", "euc_cone", "hyp_cone", "hyp_cone_exp0")
_PORTED_MODES = ("euclidean", "euc_cone")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if mode not in _PORTED_MODES:
        raise NotImplementedError(
            f"geometry mode {mode!r}: the hyperbolic modes and the "
            f"Riemannian optimizers wait for geometry/poincare.py and "
            f"optim/rsgd.py (ROADMAP.md queue A items 11-12)")


def geometry_map(x: torch.Tensor, mode: str,
                 K: Optional[float]) -> torch.Tensor:
    """Apply the per-mode geometry post-map to raw embedding vectors."""
    _check_mode(mode)
    if mode == "euc_cone":
        n = torch.sqrt(torch.clamp_min((x * x).sum(-1, keepdim=True), 1e-24))
        return x / n * (n + K)
    return x


class LabelEmbedder(nn.Module):
    """Embedding table + geometry post-map; rows start N(0, 1)."""

    def __init__(self, n_nodes: int, dim: int, mode: str = "euclidean",
                 K: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_mode(mode)
        self.mode, self.K = mode, K
        self.embedding = nn.Parameter(
            torch.randn((n_nodes, dim), generator=generator))

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
