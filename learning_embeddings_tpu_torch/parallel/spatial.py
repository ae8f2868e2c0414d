"""Spatial partitioning: an image batch's H axis sharded over the mesh's
'model' axis, with the collectives that GSPMD inserts in the JAX
package's program written out (JAX ``train/classifier.py:96-99, 194-200``
puts the images on ``P("data", "model")``).

Each rank of a model group holds a block of `h` consecutive rows of every
activation, rank m rows [m·h, (m + 1)·h). A layer whose window along H is
(kernel k, stride s, padding p_top / p_bottom) runs H-sharded when

* its local height divides by its stride (a block that starts at an odd
  row would stride through the wrong rows),
* each neighbour holds the rows this rank needs (h ≥ the halo), and
* its global output height splits into the same blocks: H_out =
  parts · h / s (an unpadded 3×3/s2 pool, whose H_out is H/2 − 1, never
  does).

Then each rank takes ``halo_rows(k, s, p_top)`` = (p_top, k − s − p_top)
rows, floored at 0, from the rank above and the rank below (``_Halo``: one
``all_reduce`` of a zeroed buffer, tagged "halo"; its backward sums each
halo's gradient back into the neighbour's boundary rows, tagged
"halo_grad"); the image's own top and bottom edge take the layer's
padding value instead (0 for a conv, −inf for a max-pool, and no
gradient); and the op runs with H padding 0 and its W padding kept.

A trunk is a sequence of units (the stem, the pool, each residual block;
each conv and pool of VGG11BN and AlexNet), each a few chains of windows
from the unit's input (a block's main path and its shortcut). ``plan``
walks them from the input's height: a unit runs H-sharded while every
window of it fits; at the first unit that does not, the activation is
gathered whole over 'model' (``gather_height``) and that unit and every
later one run replicated on each model rank, as one device runs them.
The rule reads shapes only, and every rank has the same shapes, so every
rank takes the same decisions and calls the same collectives in the same
order. The global mean pool of an activation still sharded at the end is
``reduce_from_group`` of the local f32 sums, over the global H·W.

What the caller adds: BatchNorm statistics over every rank for a sharded
unit and over 'data' for a replicated one (``ops/bn.py``), and gradients
of a sharded unit's parameters summed over 'model' before the usual
reduction over 'data' (``train/classifier.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .mesh import Mesh, all_reduce_, reduce_from_group

__all__ = ["halo_rows", "Window", "conv_window", "chain_rows", "plan",
           "SpatialShards", "gather_height"]


def halo_rows(kernel: int, stride: int, pad_top: int) -> Tuple[int, int]:
    """(above, below): the rows a rank's block of an H-sharded layer needs
    from the rank above and the rank below. Output row o reads input rows
    [o·s − p_top, o·s − p_top + k); a block's outputs start at its first
    row / s, so it reads p_top rows above its block and k − s − p_top
    below it (none where that is negative)."""
    return max(int(pad_top), 0), max(int(kernel) - int(stride)
                                     - int(pad_top), 0)


@dataclasses.dataclass(frozen=True)
class Window:
    """An op's window along H: kernel, stride and the padding above and
    below the image."""
    kernel: int
    stride: int
    pad_top: int
    pad_bottom: int

    @property
    def halo(self) -> Tuple[int, int]:
        return halo_rows(self.kernel, self.stride, self.pad_top)

    def out_rows(self, height: int) -> int:
        return ((height + self.pad_top + self.pad_bottom - self.kernel)
                // self.stride + 1)

    def fits(self, h: int, parts: int) -> bool:
        """Whether the op runs H-sharded on blocks of `h` rows over
        `parts` ranks (module docstring)."""
        above, below = self.halo
        return (h % self.stride == 0 and h >= max(above, below, 1)
                and self.out_rows(h * parts) == parts * (h // self.stride))


def conv_window(conv) -> Window:
    """The H window of an ``nn.Conv2d`` with symmetric padding."""
    return Window(conv.kernel_size[0], conv.stride[0], conv.padding[0],
                  conv.padding[0])


def chain_rows(windows: Sequence[Window], h: int, parts: int):
    """The local height after the chain of `windows` from blocks of `h`
    rows, or None when one of them does not fit."""
    for w in windows:
        if not w.fits(h, parts):
            return None
        h //= w.stride
    return h


def plan(units: Sequence[Sequence[Sequence[Window]]], h: int,
         parts: int) -> List[bool]:
    """For each unit (its chains of windows), whether it runs H-sharded,
    from the input's local height `h`: while every chain fits and the
    chains agree on the output height; from the first unit that does not,
    none (module docstring)."""
    out, sharded = [], True
    for chains in units:
        if sharded:
            rows = {chain_rows(c, h, parts) for c in chains}
            sharded = None not in rows and len(rows) == 1
            if sharded:
                h = rows.pop()
        out.append(sharded)
    return out


def _edge(x, rows: int, fill: float):
    """`rows` rows of the padding value, shaped like x's rows."""
    B, C, _, W = x.shape
    return x.new_full((B, C, rows, W), fill)


class _Halo(torch.autograd.Function):
    """x (B, C, h, W) → (B, C, above + h + below, W) in channels_last
    memory: the neighbours' boundary rows (or `fill` at the image's edge)
    around this rank's block."""

    @staticmethod
    def forward(ctx, x, group, parts, index, above, below, fill):
        B, C, h, W = x.shape
        # slot m: rank m's first `below` rows (the bottom halo of rank
        # m − 1), then its last `above` rows (the top halo of rank m + 1)
        buf = x.new_zeros((parts, B, below + above, W, C))
        buf[index, :, :below] = x[:, :, :below].permute(0, 2, 3, 1)
        buf[index, :, below:] = x[:, :, h - above:].permute(0, 2, 3, 1)
        all_reduce_(buf, group, "halo")
        xp = torch.empty((B, C, above + h + below, W), dtype=x.dtype,
                         device=x.device, memory_format=torch.channels_last)
        xp[:, :, above:above + h] = x
        if above:
            xp[:, :, :above] = (buf[index - 1, :, below:].permute(0, 3, 1, 2)
                                if index > 0 else _edge(x, above, fill))
        if below:
            xp[:, :, above + h:] = (
                buf[index + 1, :, :below].permute(0, 3, 1, 2)
                if index < parts - 1 else _edge(x, below, fill))
        ctx.geometry = (group, parts, index, above, below, h)
        return xp

    @staticmethod
    def backward(ctx, g):
        group, parts, index, above, below, h = ctx.geometry
        B, C, _, W = g.shape
        dx = torch.empty((B, C, h, W), dtype=g.dtype, device=g.device,
                         memory_format=torch.channels_last)
        dx.copy_(g[:, :, above:above + h])
        # slot m: the gradient of rank m's bottom halo (rank m + 1's first
        # rows), then of its top halo (rank m − 1's last rows); the
        # padding at the image's edges takes none
        buf = g.new_zeros((parts, B, below + above, W, C))
        if index < parts - 1:
            buf[index, :, :below] = g[:, :, above + h:].permute(0, 2, 3, 1)
        if index > 0:
            buf[index, :, below:] = g[:, :, :above].permute(0, 2, 3, 1)
        all_reduce_(buf, group, "halo_grad")
        if index > 0 and below:
            dx[:, :, :below] += buf[index - 1, :, :below].permute(0, 3, 1, 2)
        if index < parts - 1 and above:
            dx[:, :, h - above:] += buf[index + 1, :, below:].permute(
                0, 3, 1, 2)
        return dx, None, None, None, None, None, None


class _GatherHeight(torch.autograd.Function):
    """The H blocks of the model group, concatenated in rank order, in
    channels_last memory. Backward: this rank's block of its own gradient,
    not summed (what follows runs the same on every model rank)."""

    @staticmethod
    def forward(ctx, x, group, parts, index):
        B, C, h, W = x.shape
        buf = x.new_zeros((B, parts, h, W, C))
        buf[:, index] = x.permute(0, 2, 3, 1)
        all_reduce_(buf, group, "gather_height")
        ctx.block = (index * h, (index + 1) * h)
        return buf.view(B, parts * h, W, C).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.block
        return (g[:, :, lo:hi].contiguous(memory_format=torch.channels_last),
                None, None, None)


def gather_height(x: torch.Tensor, group, parts: int,
                  index: int) -> torch.Tensor:
    """The whole of an H-sharded activation on every rank of `group` (the
    model group, `parts` ranks; this rank the `index`-th), with a
    gradient."""
    if group is None:
        return x
    return _GatherHeight.apply(x, group, parts, index)


class SpatialShards:
    """The H sharding of one mesh: the model group the blocks of rows lie
    on, its size and this rank's place in it, and the groups a
    BatchNorm reduces over when its layer is sharded (every rank) or
    replicated ('data')."""

    def __init__(self, mesh: Mesh):
        if mesh.n_model < 2:
            raise ValueError(f"spatial partitioning shards H over the "
                             f"'model' axis, which has one rank in {mesh}")
        self.group = mesh.model_group
        self.parts = mesh.n_model
        self.index = mesh.model_index
        self.sharded_stats_group = mesh.world_group
        self.replicated_stats_group = mesh.data_group

    def halo(self, x, above: int, below: int, fill: float):
        """x with the neighbours' `above` / `below` boundary rows around
        it (`fill` at the image's edge); x itself without a halo."""
        if above == below == 0:
            return x
        return _Halo.apply(x, self.group, self.parts, self.index, above,
                           below, fill)

    def conv2d(self, x, weight, bias, stride, padding,
               pad_h: Tuple[int, int] = None):
        """``F.conv2d`` of an H-sharded x (dilation 1, one group);
        `pad_h` = (top, bottom) where the H padding is not `padding[0]`
        on both sides (the s2d stem's (2, 1))."""
        top = padding[0] if pad_h is None else pad_h[0]
        x = self.halo(x, *halo_rows(weight.shape[2], stride[0], top), 0.0)
        return F.conv2d(x, weight, bias, stride, (0, padding[1]))

    def max_pool2d(self, x, kernel: int, stride: int, padding: int = 0):
        """``F.max_pool2d`` of an H-sharded x (square window)."""
        x = self.halo(x, *halo_rows(kernel, stride, padding),
                      float("-inf"))
        return F.max_pool2d(x, kernel, stride, (0, padding))

    def gather(self, x):
        return gather_height(x, self.group, self.parts, self.index)

    def mean(self, x):
        """The global mean over H and W of an H-sharded x, in f32 after
        rounding to x's dtype, as ``x.mean((2, 3)).float()`` gives it."""
        total = reduce_from_group(x.sum(dim=(2, 3), dtype=torch.float32),
                                  self.group)
        n = x.shape[2] * self.parts * x.shape[3]
        return (total / n).to(x.dtype).float()
