"""Backbone trunk + criterion-matched head: the port of
``learning_embeddings_tpu/models/heads.py``. The head is chosen by the
training criterion (``train/classifier.py::CRITERION_TO_HEAD``):

* ``multi_head``   : one linear layer over all n_classes (multi_level_ce,
  masked_ce, multi_label_sm)
* ``leaf``         : a linear layer over the last level only
  (last_level_ce)
* ``hsoftmax``     : a linear layer over all n_classes whose output
  ``losses.classification.make_hierarchical_softmax`` normalises
* ``bottleneck2d`` : trunk → ``bottleneck`` (a 2-d feature) → bias-free
  ``level_fc{l}`` per level (the 2-d embedding-visualisation variant)
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .resnet import make_trunk

__all__ = ["HierarchicalCNN", "HEADS"]

HEADS = ("multi_head", "leaf", "hsoftmax", "bottleneck2d")

#: width of the bottleneck2d head's feature
BOTTLENECK_DIM = 2


class HierarchicalCNN(nn.Module):
    """Backbone trunk (`trunk`: any of ``BACKBONES``, with the remat,
    stem and BatchNorm options of ``models/resnet.py``; `image_size` sizes
    a ViT's position embedding and a Swin's masks, and the convolutional
    trunks ignore it) +
    a head.

    Takes NCHW images (channels_last memory on the card) with
    `in_channels` channels (1 for grayscale) and returns raw f32 scores:
    (B, n_classes), or (B, levels[-1]) for ``leaf``. The head runs in f32
    on the trunk's f32 pooled features, as flax's ``nn.Dense`` does in the
    JAX package. For ``bottleneck2d``, ``capture_bottleneck=True`` also
    returns the 2-d feature."""

    def __init__(self, backbone: str, levels: Sequence[int],
                 head: str = "multi_head",
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3,
                 remat: bool = False, stem: str = "conv7",
                 bn_stats_rows: int = 0, bn_impl: str = "pallas",
                 bn_stats_dtype: str = "float32", image_size: int = 448):
        super().__init__()
        if head not in HEADS:
            raise ValueError(f"unknown head {head!r}; expected {HEADS}")
        self.levels = tuple(int(n) for n in levels)
        self.head = head
        self.trunk = make_trunk(backbone, dtype=dtype,
                                in_channels=in_channels, remat=remat,
                                stem=stem, bn_stats_rows=bn_stats_rows,
                                bn_impl=bn_impl,
                                bn_stats_dtype=bn_stats_dtype,
                                image_size=image_size)
        feat = self.trunk.feature_dim
        if head == "bottleneck2d":
            self.bottleneck = nn.Linear(feat, BOTTLENECK_DIM)
            for l, n in enumerate(self.levels):
                self.add_module(f"level_fc{l}",
                                nn.Linear(BOTTLENECK_DIM, n, bias=False))
        else:
            self.fc = nn.Linear(
                feat, self.levels[-1] if head == "leaf" else sum(self.levels))

    def forward(self, x, capture_bottleneck: bool = False):
        feats = self.trunk(x)
        if self.head != "bottleneck2d":
            return self.fc(feats)
        z = self.bottleneck(feats)
        scores = torch.cat([getattr(self, f"level_fc{l}")(z)
                            for l in range(len(self.levels))], dim=-1)
        return (scores, z) if capture_bottleneck else scores
