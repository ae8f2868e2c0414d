"""The Vision Transformer trunk: Dosovitskiy et al., "An Image is Worth
16x16 Words", arXiv:2010.11929, ViT-L/16 (Table 1: 24 layers, width
1024, MLP 4096, 16 heads, patch 16) as a trunk of the hierarchical
classifier. The JAX package has no transformer; this trunk is the
port's own.

* Parameter names are torchvision's ``vit_l_16`` (``conv_proj``,
  ``class_token``, ``encoder.pos_embedding``, ``encoder.layers.
  encoder_layer_{i}.{ln_1, self_attention.in_proj_weight / in_proj_bias /
  out_proj, ln_2, mlp.0, mlp.3}``, ``encoder.ln``), without torchvision's
  ``heads``: the classifier's head lives in ``models/heads.py``.
* ``x = conv16/16(img)`` laid out as (B, N, D) (a free view of the
  channels_last conv output), the class token prepended and the learned
  position embedding of (N + 1, D) added; then per block
  ``x = x + out_proj(attn(LN1(x)))`` and ``x = x + mlp.3(gelu(mlp.0(
  LN2(x))))`` with one qkv projection (D → 3D) and softmax(q·kᵀ/√d)·v
  over the heads (``ops/attention.py``); a final LayerNorm; the class
  token's row as the f32 features (``feature_dim`` = D).
* Precision as the ResNets': f32 parameters, each cast to the activation
  dtype at use; a bf16 activation and residual stream; LayerNorm's
  statistics, the exact (erf) GELU and the softmax computed in f32 inside
  their ops. No dropout and no stochastic depth.
* The position embedding is learned at the trunk's own grid,
  (`image_size` / `patch`)² + 1 tokens: 785 at 448² for ViT-L/16.
* ``resnet.init_params_`` initialises it from a seed through the
  ``reset_parameters_`` methods here: the class token and position
  embedding normal with std 0.02, the qkv projection LeCun-normal as
  every linear layer, LayerNorm scale 1 and bias 0.
* ``remat=True`` runs each block under ``torch.utils.checkpoint``
  (non-reentrant) and recomputes it in the backward pass. The `stem` and
  `bn_*` arguments are accepted and unused, as AlexNet's are. There is
  no spatial partitioning: no block works on windows of H.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from .resnet import Conv2d, lecun_normal_

__all__ = ["VisionTransformer", "EncoderBlock", "SelfAttention",
           "vit_l_16"]

#: LayerNorm's eps in ViT
LN_EPS = 1e-6


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim whose f32 scale and bias are cast to the
    input's dtype at use; the statistics are f32 inside the op."""

    def __init__(self, dim: int, eps: float = LN_EPS):
        super().__init__(dim, eps=eps)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        """Scale 1, bias 0 (``resnet.init_params_`` calls this)."""
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


class Linear(nn.Linear):
    """Linear layer whose f32 weight and bias (if any) are cast to the
    input's dtype at use."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class SelfAttention(nn.Module):
    """Multi-head self-attention with one qkv projection (torchvision's
    ``in_proj_weight`` (3D, D) and ``in_proj_bias``) and ``out_proj``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        if dim % heads:
            raise ValueError(f"width {dim} does not split into {heads} "
                             f"heads")
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Linear(dim, dim)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        """The qkv projection LeCun-normal with bias 0, as every other
        linear layer; ``out_proj`` is one of those."""
        lecun_normal_(self.in_proj_weight, generator)
        self.in_proj_bias.zero_()

    def forward(self, x):
        B, N, D = x.shape
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype),
                       self.in_proj_bias.to(x.dtype))
        # (B, N, 3, H, d) → three (B, H, N, d) views
        q, k, v = qkv.view(B, N, 3, self.heads, D // self.heads).permute(
            2, 0, 3, 1, 4).unbind(0)
        y = attention(q, k, v)
        return self.out_proj(y.transpose(1, 2).reshape(B, N, D))


class EncoderBlock(nn.Module):
    """Pre-LN transformer block: attention then MLP, each residual."""

    def __init__(self, dim: int, heads: int, mlp_dim: int):
        super().__init__()
        self.ln_1 = LayerNorm(dim)
        self.self_attention = SelfAttention(dim, heads)
        self.ln_2 = LayerNorm(dim)
        self.mlp = nn.Sequential(Linear(dim, mlp_dim), nn.GELU(),
                                 nn.Identity(), Linear(mlp_dim, dim))

    def forward(self, x):
        x = x + self.self_attention(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Encoder(nn.Module):
    """The position embedding, the blocks and the final LayerNorm."""

    def __init__(self, tokens: int, depth: int, dim: int, heads: int,
                 mlp_dim: int):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.empty(1, tokens, dim))
        self.layers = nn.Sequential(collections.OrderedDict(
            (f"encoder_layer_{i}", EncoderBlock(dim, heads, mlp_dim))
            for i in range(depth)))
        self.ln = LayerNorm(dim)


class VisionTransformer(nn.Module):
    """The trunk: images (B, C, H, W) (channels_last memory) → the class
    token's f32 features (B, `width`)."""

    def __init__(self, image_size: int = 448, patch: int = 16,
                 depth: int = 24, width: int = 1024, heads: int = 16,
                 mlp_dim: int = 4096, dtype: torch.dtype = torch.bfloat16,
                 in_channels: int = 3, remat: bool = False,
                 stem: str = "conv7", bn_impl: str = "pallas",
                 bn_stats_rows: int = 0, bn_stats_dtype: str = "float32"):
        super().__init__()
        if image_size % patch:
            raise ValueError(f"image size {image_size} is not a multiple of "
                             f"the patch {patch}")
        self.patch = int(patch)
        self.dtype = dtype
        self.remat = remat
        self.feature_dim = width
        self.conv_proj = Conv2d(in_channels, width, patch, patch, bias=True)
        self.class_token = nn.Parameter(torch.empty(1, 1, width))
        self.encoder = Encoder((image_size // patch) ** 2 + 1, depth, width,
                               heads, mlp_dim)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        """The class token and the position embedding normal with std
        0.02 (ViT's position embedding), from `generator`; the walk of
        ``resnet.init_params_`` reaches the layers below."""
        self.class_token.normal_(0.0, 0.02, generator=generator)
        self.encoder.pos_embedding.normal_(0.0, 0.02, generator=generator)

    def _block(self, blk, x):
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(blk, x, use_reentrant=False,
                              preserve_rng_state=False)
        return blk(x)

    def forward(self, x):
        x = self.conv_proj(x.to(self.dtype))
        B, D, h, w = x.shape
        if (h * w + 1) != self.encoder.pos_embedding.shape[1]:
            raise ValueError(
                f"{x.shape[2] * self.patch}×{x.shape[3] * self.patch} "
                f"images give {h * w} patches; this trunk's position "
                f"embedding holds {self.encoder.pos_embedding.shape[1] - 1}")
        x = x.permute(0, 2, 3, 1).reshape(B, h * w, D)
        cls = self.class_token.to(x.dtype).expand(B, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.encoder.pos_embedding.to(
            x.dtype)
        for blk in self.encoder.layers:
            x = self._block(blk, x)
        return self.encoder.ln(x[:, 0]).float()


def vit_l_16(**kw) -> VisionTransformer:
    """ViT-L/16 (24 × 1024 / 4096 / 16 heads, patch 16); `image_size`
    (default 448) sizes the position embedding."""
    return VisionTransformer(patch=16, depth=24, width=1024, heads=16,
                             mlp_dim=4096, **kw)
