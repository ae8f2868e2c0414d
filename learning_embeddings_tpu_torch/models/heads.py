"""Backbone trunk + criterion-matched head: the port of
``learning_embeddings_tpu/models/heads.py``.

Only the ``multi_head`` head (one linear layer over all n_classes, for
multi_level_ce) is ported so far; ``leaf``, ``hsoftmax`` and
``bottleneck2d`` follow with their criteria (ROADMAP.md queue A item 4).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .resnet import BACKBONES

__all__ = ["HierarchicalCNN", "HEADS"]

HEADS = ("multi_head", "leaf", "hsoftmax", "bottleneck2d")


class HierarchicalCNN(nn.Module):
    """ResNet trunk (`trunk`) + linear head (`fc`) over all taxonomy nodes.

    Takes NCHW images (channels_last memory on the card) and returns raw
    f32 scores (B, n_classes). The head runs in f32 on the trunk's f32
    pooled features, as flax's ``nn.Dense`` does in the JAX package."""

    def __init__(self, backbone: str, levels: Sequence[int],
                 head: str = "multi_head",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if head not in HEADS:
            raise ValueError(f"unknown head {head!r}; expected {HEADS}")
        if head != "multi_head":
            raise NotImplementedError(
                f"head {head!r} is not ported yet (ROADMAP.md queue A item 4)")
        if backbone not in BACKBONES:
            raise NotImplementedError(
                f"backbone {backbone!r} is not ported yet; ported: "
                f"{sorted(BACKBONES)} (ROADMAP.md queue A item 18)")
        self.levels = tuple(int(n) for n in levels)
        self.trunk = BACKBONES[backbone](dtype=dtype)
        self.fc = nn.Linear(self.trunk.feature_dim, sum(self.levels))

    def forward(self, x):
        return self.fc(self.trunk(x))
