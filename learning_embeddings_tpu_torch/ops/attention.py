"""Multi-head attention softmax(q·kᵀ/√D)·v over (B, H, N, D) tensors,
the one attention op of the port (``models/vit.py``).

* On a card it is PyTorch's fused scaled-dot-product attention pinned to
  the cuDNN backend (``torch.nn.attention.sdpa_kernel`` with that backend
  alone): where cuDNN's kernel cannot take the inputs the call raises,
  and never falls back to another route unnoticed. The backward is the
  pinned kernel's own (the autograd node that its forward records).
  cuDNN's ran forward and backward at 2.75× the flash backend's speed at
  ViT-L/16's 448² shape on an H100 (B 64, 16 heads, 785 tokens of 64;
  ``tools/attention_backends.py`` times both).
* On the CPU it is the plain math: the scores and the softmax in f32,
  the result rounded once to q's dtype, differentiated by autograd.

Every call counts as "attention" (``utils/profiling.py``'s ``count``):
one for the forward and one for its backward, so a ViT-L/16 train step
counts 48 (72 with ``remat``, whose recomputed forward counts again).
While a ``torch.profiler`` records, the forward runs in the device span
"attention.fwd" and the backward in "attention.bwd"
(``utils/profiling.py``): the backward's span opens in the autograd node
after the output and closes in the one before the inputs, so it
encloses the attention's own backward node.
"""

from __future__ import annotations

import math

import torch
from torch.autograd import profiler as _autograd_profiler

from ..utils import profiling

__all__ = ["attention"]


def _math(q, k, v):
    s = torch.matmul(q.float(), k.float().transpose(-2, -1)) \
        / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def _fused(q, k, v):
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
        return torch.nn.functional.scaled_dot_product_attention(q, k, v)


class _Box:
    """The backward span of one call, open between the two nodes."""
    __slots__ = ("span",)

    def __init__(self):
        self.span = None


class _BackwardStarts(torch.autograd.Function):
    """Identity on the output; its backward counts the backward launch
    and, under a profiler, opens the span "attention.bwd"."""

    @staticmethod
    def forward(ctx, out, box):
        ctx.box = box
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        profiling.count("attention")
        if _autograd_profiler._is_profiler_enabled:
            ctx.box.span = profiling.span("attention.bwd", g.device)
            ctx.box.span.__enter__()
        return g, None


class _BackwardEnds(torch.autograd.Function):
    """Identity on q, k, v; its backward closes the span that
    ``_BackwardStarts`` opened."""

    @staticmethod
    def forward(ctx, q, k, v, box):
        ctx.box = box
        return q.view_as(q), k.view_as(k), v.view_as(v)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        if ctx.box.span is not None:
            ctx.box.span.__exit__(None, None, None)
            ctx.box.span = None
        return dq, dk, dv, None


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ/√D)·v for q, k, v of shape (B, H, N, D), in q's
    dtype."""
    box = _Box()
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if grad:
        q, k, v = _BackwardEnds.apply(q, k, v, box)
    profiling.count("attention")
    out = profiling.in_device_span(
        "attention.fwd", q.device,
        _fused if q.device.type == "cuda" else _math, q, k, v)
    return _BackwardStarts.apply(out, box) if grad else out
