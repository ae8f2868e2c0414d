"""The Swin Transformer trunk: Liu et al., "Swin Transformer: Hierarchical
Vision Transformer using Shifted Windows", arXiv:2103.14030, Swin-L
(Table 1 and §3.3: patch 4, C = 192, depths {2, 2, 18, 2}, heads {6, 12,
24, 48}, MLP ratio 4, window 12 at 384²) as a trunk of the hierarchical
classifier. The JAX package has no transformer; this trunk is the
port's own.

* Parameter names are torchvision's ``swin_b`` at Swin-L's widths
  (``features.0.0`` the 4/4 patch conv, ``features.0.2`` its LayerNorm;
  ``features.{1,3,5,7}.{j}.{norm1, attn.qkv, attn.proj,
  attn.relative_position_bias_table, norm2, mlp.0, mlp.3}`` the blocks
  of the four stages; ``features.{2,4,6}.{norm, reduction}`` the patch
  merging between them; ``norm`` the final LayerNorm), without
  torchvision's ``head``: the classifier's head lives in
  ``models/heads.py``.
* The stream is (B, H, W, C) (a free view of the channels_last patch
  conv's output). Each block is ``x = x + unwindows(attn(windows(
  norm1(x))))`` then ``x = x + mlp.3(gelu(mlp.0(norm2(x))))``. Blocks
  alternate W-MSA (shift 0) and SW-MSA (shift ``window // 2``); a stage
  whose grid is one window does not shift (the last one at 384²).
  ``windows`` rolls the grid by −shift and cuts it into windows of
  ``window²`` tokens, (B, nW, N, C); ``unwindows`` puts them back and
  rolls by +shift. Both run in the device span "swin.windows" and their
  backward in "swin.windows.bwd" (``profiling.traced_op``), each pass
  counted as "swin_windows": 4 a block and train step, 96 for Swin-L (144
  with ``remat``, whose recomputed forward counts again).
* The attention of a window: one qkv projection (C → 3C, with bias),
  softmax(q·kᵀ/√d + B + M)·v of every window and head read from it as it
  lies, (B, nW, N, 3C), and written as (B, nW, N, C)
  (``ops/window_attention.py``: on a card a hand-written kernel pair, on
  the CPU ``ops/attention.py``'s softmax math), then ``proj``. B is the
  learned relative-position bias: a table
  of (2·window − 1)² rows × H gathered by the fixed index of §3.2, (H,
  N, N). M is the shift's region mask, (nW, N, N): −100 between tokens
  that the roll brought from different regions of the grid, 0 elsewhere,
  as the official code and torchvision make it. B + M is one (1, nW·H, N,
  N) bias, broadcast over the images; its gradient reaches the table
  through the gather.
* Patch merging: the 2×2 neighbours concatenated (torchvision's order
  x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]), then
  LayerNorm(4C) and ``reduction`` (4C → 2C, no bias).
* The features: the final LayerNorm, then the mean over the grid in f32
  (``feature_dim`` = 8C).
* Precision as the ViT's: f32 parameters, each cast to the activation
  dtype at use (the bias B + M too, after it is summed in f32); a bf16
  stream; LayerNorm's statistics, the GELU and the softmax in f32 inside
  their ops. LayerNorm eps 1e-5. No dropout and no stochastic depth.
* ``resnet.init_params_`` initialises it from a seed: the relative-bias
  tables normal with std 0.02 cut at two standard deviations (the
  ``reset_parameters_`` here), every linear and conv layer LeCun-normal
  with bias 0, LayerNorm scale 1 and bias 0.
* ``remat=True`` runs each block under ``torch.utils.checkpoint``
  (non-reentrant). The `stem` and `bn_*` arguments are accepted and
  unused, as the ViT's are; there is no spatial partitioning.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.window_attention import window_attention
from ..utils import profiling
from .resnet import Conv2d
from .vit import LayerNorm, Linear

__all__ = ["SwinTransformer", "SwinBlock", "ShiftedWindowAttention",
           "PatchMerging", "relative_position_index", "shift_mask",
           "windows", "unwindows", "swin_l"]

#: LayerNorm's eps in Swin
LN_EPS = 1e-5
#: the mask's value between tokens of different regions
MASKED = -100.0


def relative_position_index(window: int) -> torch.Tensor:
    """(N·N,) rows of the relative-bias table, N = window²: token i =
    (yi, xi) and token j give (yi − yj + w − 1)·(2w − 1) + (xi − xj + w
    − 1)."""
    yx = torch.stack(torch.meshgrid(torch.arange(window),
                                    torch.arange(window), indexing="ij"))
    rel = (yx.flatten(1)[:, :, None] - yx.flatten(1)[:, None, :]
           + window - 1)
    return (rel[0] * (2 * window - 1) + rel[1]).flatten()


def _partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) → (B, nW, window², C), windows in row-major order."""
    B, H, W, C = x.shape
    return x.view(B, H // window, window, W // window, window, C).permute(
        0, 1, 3, 2, 4, 5).reshape(B, (H // window) * (W // window),
                                  window * window, C)


def _merge(x: torch.Tensor, grid: int, window: int) -> torch.Tensor:
    """The inverse of ``_partition`` on a grid × grid image."""
    B, _, _, C = x.shape
    n = grid // window
    return x.view(B, n, n, window, window, C).permute(
        0, 1, 3, 2, 4, 5).reshape(B, grid, grid, C)


def shift_mask(grid: int, window: int, shift: int) -> torch.Tensor:
    """(nW, N, N) f32: ``MASKED`` where the rolled grid puts tokens of
    different regions into one window, 0 elsewhere. The regions cut each
    axis at −window and −shift (the official code's slices)."""
    region = torch.zeros(1, grid, grid, 1)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for i, (hs, ws) in enumerate((h, w) for h in cuts for w in cuts):
        region[:, hs, ws] = i
    r = _partition(region, window).squeeze(-1).squeeze(0)       # (nW, N)
    return torch.where(r[:, None, :] != r[:, :, None],
                       torch.tensor(MASKED), torch.tensor(0.0))


def _windows(x, window, shift):
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    return _partition(x, window)


def _unwindows(x, grid, window, shift):
    x = _merge(x, grid, window)
    return torch.roll(x, (shift, shift), (1, 2)) if shift else x


def windows(x: torch.Tensor, window: int, shift: int) -> torch.Tensor:
    """(B, H, W, C) rolled by −`shift` and cut into windows: (B, nW, N,
    C); in the span "swin.windows", counted "swin_windows"."""
    return profiling.traced_op("swin.windows", "swin.windows.bwd",
                               ("swin_windows",), _windows, x, window,
                               shift)


def unwindows(x: torch.Tensor, grid: int, window: int,
              shift: int) -> torch.Tensor:
    """The inverse of ``windows``: (B, nW, N, C) → (B, grid, grid, C)."""
    return profiling.traced_op("swin.windows", "swin.windows.bwd",
                               ("swin_windows",), _unwindows, x, grid,
                               window, shift)


class ShiftedWindowAttention(nn.Module):
    """Multi-head self-attention within windows, with the learned
    relative-position bias (torchvision's ``qkv``, ``proj``,
    ``relative_position_bias_table``)."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        if dim % heads:
            raise ValueError(f"width {dim} does not split into {heads} "
                             f"heads")
        self.heads, self.window = heads, window
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(window),
                             persistent=False)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        """The table normal with std 0.02, cut at two standard
        deviations; ``qkv`` and ``proj`` are linear layers of the walk."""
        nn.init.trunc_normal_(self.relative_position_bias_table, 0.0, 0.02,
                              -0.04, 0.04, generator=generator)

    def bias(self, mask: Optional[torch.Tensor],
             n_windows: int) -> torch.Tensor:
        """B + M as one f32 (1, nW·H, N, N) bias: the table gathered to
        (H, N, N), plus the mask (nW, N, N) if any."""
        N = self.window ** 2
        rel = self.relative_position_bias_table[
            self.relative_position_index].view(N, N, self.heads).permute(
            2, 0, 1)
        b = (rel.unsqueeze(0) + mask.unsqueeze(1) if mask is not None
             else rel.expand(n_windows, -1, -1, -1))
        # the window attention's kernel takes a contiguous bias
        return b.reshape(1, n_windows * self.heads, N, N).contiguous()

    def forward(self, x, mask: Optional[torch.Tensor]):
        qkv = self.qkv(x)
        bias = self.bias(mask, x.shape[1]).to(qkv.dtype)
        return self.proj(window_attention(qkv, bias, self.heads))


class SwinBlock(nn.Module):
    """Pre-LN block on a grid × grid stream: (shifted) window attention
    then MLP, each residual."""

    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 grid: int, mlp_ratio: int):
        super().__init__()
        self.grid, self.window, self.shift = grid, window, shift
        self.norm1 = LayerNorm(dim, LN_EPS)
        self.attn = ShiftedWindowAttention(dim, heads, window)
        self.norm2 = LayerNorm(dim, LN_EPS)
        self.mlp = nn.Sequential(Linear(dim, mlp_ratio * dim), nn.GELU(),
                                 nn.Identity(), Linear(mlp_ratio * dim, dim))
        self.register_buffer("attn_mask", shift_mask(grid, window, shift)
                             if shift else None, persistent=False)

    def forward(self, x):
        w, s = self.window, self.shift
        a = self.attn(windows(self.norm1(x), w, s), self.attn_mask)
        x = x + unwindows(a, self.grid, w, s)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2×2 neighbours concatenated, LayerNorm(4C), Linear(4C → 2C) with no
    bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, LN_EPS)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class _NHWC(nn.Module):
    """(B, C, H, W) → (B, H, W, C): a free view of channels_last memory
    (torchvision's ``Permute`` at ``features.0.1``)."""

    def forward(self, x):
        return x.permute(0, 2, 3, 1)


class SwinTransformer(nn.Module):
    """The trunk: images (B, C, H, W) (channels_last memory) → the mean of
    the final LayerNorm's output over the grid, f32 (B, 8·`embed_dim`)."""

    def __init__(self, image_size: int = 384, patch: int = 4,
                 embed_dim: int = 192, depths: Sequence[int] = (2, 2, 18, 2),
                 heads: Sequence[int] = (6, 12, 24, 48), window: int = 12,
                 mlp_ratio: int = 4, dtype: torch.dtype = torch.bfloat16,
                 in_channels: int = 3, remat: bool = False,
                 stem: str = "conv7", bn_impl: str = "pallas",
                 bn_stats_rows: int = 0, bn_stats_dtype: str = "float32"):
        super().__init__()
        grids = [image_size // patch // 2 ** i for i in range(len(depths))]
        if image_size % (patch * 2 ** (len(depths) - 1)) or any(
                g % window for g in grids):
            raise ValueError(f"image size {image_size} gives stage grids "
                             f"{grids}; each must be a multiple of the "
                             f"window {window}")
        self.dtype, self.remat = dtype, remat
        self.image_size = image_size
        layers = [nn.Sequential(Conv2d(in_channels, embed_dim, patch, patch,
                                       bias=True), _NHWC(),
                                LayerNorm(embed_dim, LN_EPS))]
        dim = embed_dim
        for i, (depth, h, g) in enumerate(zip(depths, heads, grids)):
            if i:
                layers.append(PatchMerging(dim))
                dim *= 2
            # a grid of one window has nothing to shift
            shift = window // 2 if g > window else 0
            layers.append(nn.Sequential(*(
                SwinBlock(dim, h, window, shift if j % 2 else 0, g,
                          mlp_ratio) for j in range(depth))))
        self.features = nn.Sequential(*layers)
        self.norm = LayerNorm(dim, LN_EPS)
        self.feature_dim = dim

    def _block(self, blk, x):
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(blk, x, use_reentrant=False,
                              preserve_rng_state=False)
        return blk(x)

    def forward(self, x):
        if x.shape[-1] != self.image_size or x.shape[-2] != self.image_size:
            raise ValueError(f"{x.shape[-2]}×{x.shape[-1]} images; this "
                             f"trunk's masks are for {self.image_size}²")
        x = self.features[0](x.to(self.dtype))
        for layer in self.features[1:]:
            if isinstance(layer, PatchMerging):
                x = layer(x)
            else:
                for blk in layer:
                    x = self._block(blk, x)
        return self.norm(x).float().mean(dim=(1, 2))


def swin_l(**kw) -> SwinTransformer:
    """Swin-L (C 192, depths 2/2/18/2, heads 6/12/24/48, window 12, patch
    4, MLP ratio 4); `image_size` (default 384) sizes its masks."""
    return SwinTransformer(patch=4, embed_dim=192, depths=(2, 2, 18, 2),
                           heads=(6, 12, 24, 48), window=12, mlp_ratio=4,
                           **kw)
