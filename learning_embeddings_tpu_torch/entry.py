"""Entry points of the port (twin of the repo's ``__graft_entry__.py``).

entry()           — the forward of the flagship model (ResNet-50 multi-head
                    hierarchical classifier at 448², bf16 trunk) with its
                    example arguments.
ethec_labelmap()  — the ETHEC merged taxonomy (6/21/135/561) when the
                    ETHEC split is present, else the shipped Butterfly200
                    taxonomy (5/23/116/200).
"""

from __future__ import annotations

import json
import os

import torch

from .hierarchy import LabelMap, butterfly200_labelmap, labelmap_from_records
from .models.heads import HierarchicalCNN
from .models.resnet import init_params_
from .train.classifier import resolve_device

__all__ = ["entry", "ethec_labelmap"]

ETHEC_LEVELS = (6, 21, 135, 561)


def ethec_labelmap() -> LabelMap:
    """Taxonomy of the flagship run: built from ``val.json`` in the
    directory named by ``ETHEC_SPLITS_DIR`` (the variable the JAX package's
    CLIs read) when that file exists; otherwise the Butterfly200 taxonomy
    that ships with the package."""
    splits_dir = os.environ.get("ETHEC_SPLITS_DIR")
    path = os.path.join(splits_dir, "val.json") if splits_dir else None
    if path is None or not os.path.exists(path):
        return butterfly200_labelmap()
    with open(path) as f:
        lm = labelmap_from_records(list(json.load(f).values()))
    # a split missing a class would silently renumber everything
    if tuple(lm.levels) != ETHEC_LEVELS:
        raise ValueError(f"ETHEC taxonomy from {path} has levels "
                         f"{lm.levels}, expected {ETHEC_LEVELS}")
    return lm


def entry(device="cuda", batch_size: int = 8, image_size: int = 448,
          dtype: torch.dtype = torch.bfloat16):
    """(fn, example_args): ``fn(model, images)`` is the eval-mode forward
    of the flagship on NHWC f32 images; weights are random from seed 0."""
    device = resolve_device(device)
    labelmap = ethec_labelmap()
    model = HierarchicalCNN(backbone="resnet50", levels=labelmap.levels,
                            head="multi_head", dtype=dtype)
    init_params_(model, torch.Generator().manual_seed(0))
    model.to(device=device, memory_format=torch.channels_last).eval()
    images = torch.zeros((batch_size, image_size, image_size, 3),
                         dtype=torch.float32, device=device)

    @torch.no_grad()
    def fn(model, images):
        return model(images.permute(0, 3, 1, 2))

    return fn, (model, images)
