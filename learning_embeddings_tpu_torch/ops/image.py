"""On-device image input ops."""

from __future__ import annotations

import torch


def device_scale(images: torch.Tensor) -> torch.Tensor:
    """uint8 batches (the low-bandwidth transfer format) scale to [0, 1] on
    the device; float inputs pass through.

    Uses true division by 255.0 (not a reciprocal multiply), so the result
    is bit-identical to the host pipeline's ``astype(float32) / 255.0`` and
    to the JAX package's ``ops/image.py::device_scale``.
    """
    if images.dtype == torch.uint8:
        return images.to(torch.float32) / 255.0
    return images
