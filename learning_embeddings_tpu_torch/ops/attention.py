"""Multi-head attention softmax(q·kᵀ/√D [+ bias])·v over (B, H, N, D)
tensors: the ViT's attention (``models/vit.py``, without a bias). The
Swin trunk calls ``ops/window_attention.py``, whose CPU route is this
module's softmax math; the biased route here is the yardstick that its
tests and ``tools/attention_backends.py`` hold the window kernels
against.

* Without a bias, on a card, it is PyTorch's fused scaled-dot-product
  attention pinned to the cuDNN backend (``torch.nn.attention.
  sdpa_kernel`` with that backend alone): where cuDNN's kernel cannot
  take the inputs the call raises, and never falls back to another route
  unnoticed. The backward is the pinned kernel's own (the autograd node
  that its forward records). cuDNN's ran forward and backward at 2.75×
  the flash backend's speed at ViT-L/16's 448² shape on an H100 (B 64,
  16 heads, 785 tokens of 64; ``tools/attention_backends.py`` times
  both).
* With an additive `bias` (broadcast to (B, H, N, N), in q's dtype), on a
  card, it is the same fused attention with the bias as its float
  ``attn_mask``, pinned to the memory-efficient backend: it raises
  where that backend cannot take the inputs. Its backward gives the
  bias its gradient (summed over the dims the bias broadcasts over). cuDNN's backend has no kernel for a bias that takes
  a gradient (PyTorch's cuDNN attention backward returns dq, dk and dv
  alone), and the math backend took 2.66× the memory-efficient one's
  time: 206.8 against 77.8 ms for the forward and backward of Swin-L's 24
  blocks at B 64 on an H100 (its four stage shapes, 144 tokens of 32,
  windows folded into the heads; ``tools/attention_backends.py``).
* On the CPU it is the plain math: the scores (plus the bias) and the
  softmax in f32, the result rounded once to q's dtype, differentiated
  by autograd, the bias's gradient included.

Every call counts as "attention" (``utils/profiling.py``'s ``count``),
and a call with a bias also as "attention_bias": one for the forward
and one for its backward, so a ViT-L/16 train step counts 48 "attention"
(72 with ``remat``, whose recomputed forward counts again). While a
``torch.profiler`` records, the forward runs in the device span
"attention.fwd" and the backward in "attention.bwd"
(``profiling.traced_op``): the backward's span opens in
the autograd node after the output and closes in the one before the
inputs, so it encloses the attention's own backward node.
"""

from __future__ import annotations

import math

import torch

from ..utils import profiling

__all__ = ["attention"]


def _math(q, k, v, bias=None):
    s = torch.matmul(q.float(), k.float().transpose(-2, -1)) \
        / math.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias.float()
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def _fused(q, k, v):
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
        return torch.nn.functional.scaled_dot_product_attention(q, k, v)


def _fused_bias(q, k, v, bias):
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=bias)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor = None) -> torch.Tensor:
    """softmax(q·kᵀ/√D + bias)·v for q, k, v of shape (B, H, N, D), in
    q's dtype; `bias` (None: no bias) broadcasts to (B, H, N, N) and has
    q's dtype."""
    on_card = q.device.type == "cuda"
    if bias is None:
        return profiling.traced_op(
            "attention.fwd", "attention.bwd", ("attention",),
            _fused if on_card else _math, q, k, v)
    if bias.dtype != q.dtype:
        raise ValueError(f"the attention bias is {bias.dtype}; the fused "
                         f"attention takes it in q's dtype, {q.dtype}")
    return profiling.traced_op(
        "attention.fwd", "attention.bwd", ("attention", "attention_bias"),
        _fused_bias if on_card else _math, q, k, v, bias)
