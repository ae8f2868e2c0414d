"""The backbone zoo in PyTorch: the port of ``learning_embeddings_tpu/
models/resnet.py`` (ResNet-18 to -152, ``AlexNet``, ``VGG11BN``), and
the port's own ViT-L/16 (``models/vit.py``) and Swin-L
(``models/swin.py``), registered here.

* Parameter names are torchvision's for the ResNets (conv1, bn1,
  layer{i}.{j}.conv{k} / bn{k} / downsample.{0,1}), so a JAX tree carried
  over by ``models/jax_import.py`` or a torchvision state dict loads as it
  is. ``AlexNet`` and ``VGG11BN`` number their layers as flax names them
  (``Conv_k`` → ``conv{k}``, ``Dense_k`` → ``dense{k}``, the k-th
  BatchNorm → ``bn{k}``).
* Mixed precision as in flax's ``dtype=bfloat16, param_dtype=float32``:
  parameters are f32, the input is cast to `dtype` once, and each conv
  casts its weight (and bias) to the activation dtype at use. The pooled
  features come out in f32 (AlexNet's two Dense layers run in f32). No
  autocast region is used, so the head stays f32.
* Layout: the caller passes NCHW tensors in channels_last memory (an NHWC
  batch ``permute(0, 3, 1, 2)`` is one), and the trainer puts the model in
  channels_last, so every BatchNorm input is a free (R, C) view.
* Padding: stem 7×7/s2 pad 3, max-pool 3×3/s2 pad 1 (with −inf), the
  stride of a bottleneck on its 3×3 conv, and a downsample branch exactly
  when the residual's shape changes. AlexNet pools 3×3/s2 without padding.
* BatchNorm: ``ops.bn.make_norm(bn_impl, bn_stats_rows, bn_stats_dtype)``
  picks the route, with the JAX package's precedence. Unlike the JAX
  package's ``VGG11BN``, which always runs flax's BatchNorm, the port's
  takes ``bn_impl`` like the ResNets (default 'pallas': the kernels).
  Each ``relu(bn(x) [+ residual])`` is the BatchNorm's ``act(x,
  residual)``, one pass on the card; a downsample's BatchNorm, which no
  ReLU follows, is ``bn(x)``.
* ``stem='s2d'``: space-to-depth(2), channels in the JAX package's order
  (u·2 + v)·C + c (``F.pixel_unshuffle`` orders them c·4 + u·2 + v), then
  a 4×4/s1 conv after an asymmetric (2, 1) ``F.pad``: the exact
  reparametrisation of the 7×7/s2/p3 stem (``s2d_stem_kernel``).
* ``remat=True``: each residual block runs under ``torch.utils.checkpoint``
  (non-reentrant) and is recomputed in the backward pass, the stem is not;
  the recompute leaves the BatchNorm running statistics alone (see
  ``ops/bn.py``). AlexNet and VGG11BN take `remat` and `stem` for a
  uniform signature and ignore them, as the JAX package's do.
* Spatial partitioning: a trunk whose ``spatial`` is a
  ``parallel.spatial.SpatialShards`` takes blocks of H (this rank's rows of
  every image over the mesh's 'model' axis) and runs as a sequence of
  units (``spatial_units``: the stem, the pool and each residual block;
  each conv and pool of AlexNet and VGG11BN), each H-sharded with halo
  exchanges while its windows fit, then gathered whole and replicated
  (``parallel.spatial.plan``). Each unit's BatchNorms reduce over every
  rank while it is sharded and over 'data' once it is replicated. Under
  remat a recomputed block runs its halo exchanges again, in the same
  order on every rank. With ``spatial`` None (the default) every op is
  the one-device op.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.bn import (BatchNormBase, GhostBatchNorm, make_norm,
                      set_batch_norm_group)
from ..parallel.spatial import Window, conv_window, plan

__all__ = [
    "BasicBlock",
    "Bottleneck",
    "ResNet",
    "AlexNet",
    "VGG11BN",
    "GhostBatchNorm",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "resnet152",
    "vit_l_16",
    "swin_l",
    "BACKBONES",
    "STEMS",
    "make_trunk",
    "init_params_",
    "lecun_normal_",
    "space_to_depth",
    "s2d_stem_kernel",
    "spatial_halo_counts",
    "spatial_parameters",
]

STEMS = ("conv7", "s2d")


class Conv2d(nn.Conv2d):
    """Conv whose f32 weight (and bias) is cast to the input's dtype; with
    `sp` (a ``SpatialShards``) x is this rank's block of H and the conv
    takes its halo (`pad_h`: an H padding other than ``padding[0]`` on
    both sides)."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, bias=False):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=bias)

    def forward(self, x, sp=None, pad_h=None):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        weight = self.weight.to(x.dtype)
        if sp is None:
            return self._conv_forward(x, weight, bias)
        return sp.conv2d(x, weight, bias, self.stride, self.padding, pad_h)


def _max_pool(x, kernel, stride, padding, sp):
    if sp is None:
        return F.max_pool2d(x, kernel, stride, padding)
    return sp.max_pool2d(x, kernel, stride, padding)


def _shortcut_windows(block):
    return ([] if block.downsample is None
            else [conv_window(block.downsample[0])])


def _run_units(trunk, x, units):
    """`units` ((modules, fn(x, sp), chains of H windows) each) in order
    on x, then the global mean pool in f32. With ``trunk.spatial``: each
    unit H-sharded while the plan says so, its BatchNorms reducing over
    every rank; from the first unit that is not, x gathered whole and the
    rest replicated, reducing over 'data'."""
    sp = trunk.spatial
    if sp is None:
        for _, fn, _ in units:
            x = fn(x, None)
        return x.mean(dim=(2, 3)).float()
    sharded = True
    for (modules, fn, _), on in zip(units, plan(
            [chains for _, _, chains in units], x.shape[2], sp.parts)):
        if sharded and not on:
            x = sp.gather(x)
            sharded = False
        for m in modules:
            if on:
                set_batch_norm_group(m, sp.sharded_stats_group, sp.parts)
            else:
                set_batch_norm_group(m, sp.replicated_stats_group)
        x = fn(x, sp if on else None)
    return sp.mean(x) if sharded else x.mean(dim=(2, 3)).float()


def _sharded_units(trunk, height: int, parts: int):
    """(index, unit) of the units that run H-sharded on images of
    `height` rows over `parts` model ranks."""
    units = trunk.spatial_units()
    on = plan([chains for _, _, chains in units], height // parts, parts)
    return [(i, u) for i, (u, sharded) in enumerate(zip(units, on))
            if sharded]


def spatial_parameters(trunk, height: int, parts: int) -> list:
    """The parameters of the units of `trunk` that run H-sharded on images
    of `height` rows over `parts` model ranks: each model rank computes
    their gradient from its rows only, so it is summed over 'model'."""
    return [p for _, (modules, _, _) in _sharded_units(trunk, height, parts)
            for m in modules for p in m.parameters()]


def spatial_halo_counts(trunk, height: int, parts: int,
                        remat: bool = False) -> dict:
    """The halo exchanges one train step of `trunk` makes on each rank for
    images of `height` rows over `parts` model ranks: "halo" in the
    forward pass (again for each recomputed block under `remat`) and
    "halo_grad" in the backward pass (none for the first unit, whose input
    is the image). A window with no halo rows exchanges nothing."""
    fwd = bwd = 0
    for i, (modules, _, chains) in _sharded_units(trunk, height, parts):
        n = sum(w.halo != (0, 0) for chain in chains for w in chain)
        block = any(isinstance(m, (BasicBlock, Bottleneck))
                    for m in modules)
        fwd += n * (2 if remat and block else 1)
        bwd += n if i else 0
    return {"halo": fwd, "halo_grad": bwd}


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, norm):
        super().__init__()
        self.conv1 = Conv2d(cin, filters, 3, stride, 1)
        self.bn1 = norm(filters)
        self.conv2 = Conv2d(filters, filters, 3, 1, 1)
        self.bn2 = norm(filters)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.Sequential(
                Conv2d(cin, filters, 1, stride), norm(filters))

    def forward(self, x, sp=None):
        y = self.bn1.act(self.conv1(x, sp))
        residual = x if self.downsample is None else self.downsample(x)
        return self.bn2.act(self.conv2(y, sp), residual)

    def windows(self):
        """The chains of H windows from the block's input: the main path
        and the shortcut."""
        return [[conv_window(self.conv1), conv_window(self.conv2)],
                _shortcut_windows(self)]


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, norm):
        super().__init__()
        cout = filters * self.expansion
        self.conv1 = Conv2d(cin, filters, 1)
        self.bn1 = norm(filters)
        self.conv2 = Conv2d(filters, filters, 3, stride, 1)
        self.bn2 = norm(filters)
        self.conv3 = Conv2d(filters, cout, 1)
        self.bn3 = norm(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride), norm(cout))

    def forward(self, x, sp=None):
        y = self.bn1.act(self.conv1(x))
        y = self.bn2.act(self.conv2(y, sp))
        residual = x if self.downsample is None else self.downsample(x)
        return self.bn3.act(self.conv3(y), residual)

    def windows(self):
        """The chains of H windows from the block's input: the main path
        and the shortcut."""
        return [[conv_window(self.conv1), conv_window(self.conv2),
                 conv_window(self.conv3)], _shortcut_windows(self)]


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, 4C, H/2, W/2) with z[:, (u·2 + v)·C + c, p, q] =
    x[:, c, 2p + u, 2q + v]: the JAX package's channel order, in
    channels_last memory."""
    B, C, H, W = x.shape
    if H % 2 or W % 2:
        raise ValueError(f"the s2d stem needs an even height and width, "
                         f"got {H}×{W}")
    z = x.permute(0, 2, 3, 1).reshape(B, H // 2, 2, W // 2, 2, C)
    z = z.permute(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)
    return z.permute(0, 3, 1, 2)


@torch.no_grad()
def s2d_stem_kernel(w7: torch.Tensor) -> torch.Tensor:
    """A 7×7/s2 stem kernel (O, C, 7, 7) as the equivalent space-to-depth
    4×4/s1 kernel (O, 4C, 4, 4): with input offset di − 3 = 2a + u, the tap
    w[o, c, di, dj] lands at ŵ[o, (u·2 + v)·C + c, a + 2, b + 2]; taps
    with di or dj outside [0, 7) are zero (JAX ``s2d_stem_kernel`` in
    OIHW)."""
    O, C = w7.shape[:2]
    out = w7.new_zeros((O, 4 * C, 4, 4))
    for a in range(-2, 2):
        for b in range(-2, 2):
            for u in range(2):
                for v in range(2):
                    di, dj = 2 * a + u + 3, 2 * b + v + 3
                    if 0 <= di < 7 and 0 <= dj < 7:
                        k = (u * 2 + v) * C
                        out[:, k:k + C, a + 2, b + 2] = w7[:, :, di, dj]
    return out


@contextlib.contextmanager
def _recomputing(block: nn.Module):
    """Marks the BatchNorm layers of `block` as recomputing (their running
    statistics stay as the block's first forward left them)."""
    norms = [m for m in block.modules() if isinstance(m, BatchNormBase)]
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m in norms:
            m.recomputing = False


class ResNet(nn.Module):
    """The trunk: returns the pooled f32 features (B, feature_dim), as the
    JAX ResNet does with ``features_only=True`` (heads live in
    ``models/heads.py``). `in_channels` is 1 for grayscale input."""

    def __init__(self, stage_sizes: Sequence[int], block: Type[nn.Module],
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3,
                 remat: bool = False, stem: str = "conv7",
                 bn_impl: str = "pallas", bn_stats_rows: int = 0,
                 bn_stats_dtype: str = "float32", image_size: int = None):
        super().__init__()
        if stem not in STEMS:
            raise ValueError(f"unknown stem {stem!r}; expected {STEMS}")
        norm = make_norm(bn_impl, bn_stats_rows, bn_stats_dtype, dtype)
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        #: a ``parallel.spatial.SpatialShards`` to shard H over, or None
        self.spatial = None
        self.remat = remat
        self.stem = stem
        self.conv1 = (Conv2d(4 * in_channels, 64, 4) if stem == "s2d"
                      else Conv2d(in_channels, 64, 7, 2, 3))
        self.bn1 = norm(64)
        cin = 64
        for i, n_blocks in enumerate(self.stage_sizes):
            blocks = []
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block(cin, 64 * 2**i, stride, norm))
                cin = 64 * 2**i * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.feature_dim = cin

    def _stem_forward(self, x, sp):
        if self.stem == "s2d":
            x = space_to_depth(x)
            if sp is None:
                x = self.conv1(F.pad(x, (2, 1, 2, 1)))
            else:   # W padded here, H through the halo
                x = self.conv1(F.pad(x, (2, 1)), sp, pad_h=(2, 1))
        else:
            x = self.conv1(x, sp)
        return self.bn1.act(x)

    def _block_forward(self, blk):
        def run(x, sp):
            if self.remat and self.training and torch.is_grad_enabled():
                return checkpoint(
                    blk, x, sp, use_reentrant=False,
                    preserve_rng_state=False,
                    context_fn=lambda: (contextlib.nullcontext(),
                                        _recomputing(blk)))
            return blk(x, sp)
        return run

    def spatial_units(self):
        """(modules, fn(x, sp), chains of H windows) of the stem, the pool
        and each block (``parallel/spatial.py``)."""
        stem = ([Window(2, 2, 0, 0), Window(4, 1, 2, 1)]
                if self.stem == "s2d" else [conv_window(self.conv1)])
        units = [((self.conv1, self.bn1), self._stem_forward, [stem]),
                 ((), lambda x, sp: _max_pool(x, 3, 2, 1, sp),
                  [[Window(3, 2, 1, 1)]])]
        for i in range(len(self.stage_sizes)):
            for blk in getattr(self, f"layer{i + 1}"):
                units.append(((blk,), self._block_forward(blk),
                              blk.windows()))
        return units

    def forward(self, x):
        # ends in the global average pool
        return _run_units(self, x.to(self.dtype), self.spatial_units())


class AlexNet(nn.Module):
    """The JAX package's compact AlexNet: five biased convs (11/4, 5, 3, 3,
    3; 'same'-style padding k//2) with ReLU, 3×3/s2 max-pools without
    padding after the 1st, 2nd and 5th, a global mean, then two f32 Dense
    4096 layers with ReLU. No BatchNorm: the `bn_*`, `remat` and `stem`
    arguments are accepted and unused."""

    LAYERS = ((64, 11, 4, True), (192, 5, 1, True), (384, 3, 1, False),
              (256, 3, 1, False), (256, 3, 1, True))
    feature_dim = 4096

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 in_channels: int = 3, remat: bool = False,
                 stem: str = "conv7", bn_impl: str = "pallas",
                 bn_stats_rows: int = 0, bn_stats_dtype: str = "float32",
                 image_size: int = None):
        super().__init__()
        self.dtype = dtype
        self.spatial = None
        cin = in_channels
        for k, (filters, kernel, stride, _) in enumerate(self.LAYERS):
            self.add_module(f"conv{k}", Conv2d(cin, filters, kernel, stride,
                                               kernel // 2, bias=True))
            cin = filters
        self.dense0 = nn.Linear(cin, 4096)
        self.dense1 = nn.Linear(4096, 4096)

    def spatial_units(self):
        """(modules, fn(x, sp), chains of H windows) of each conv and pool
        (``parallel/spatial.py``); no BatchNorm."""
        units = []
        for k, (_, _, _, pool) in enumerate(self.LAYERS):
            conv = getattr(self, f"conv{k}")
            units.append(((conv,), lambda x, sp, conv=conv:
                          F.relu(conv(x, sp)), [[conv_window(conv)]]))
            if pool:
                units.append(((), lambda x, sp: _max_pool(x, 3, 2, 0, sp),
                              [[Window(3, 2, 0, 0)]]))
        return units

    def forward(self, x):
        x = _run_units(self, x.to(self.dtype), self.spatial_units())
        return F.relu(self.dense1(F.relu(self.dense0(x))))


class VGG11BN(nn.Module):
    """VGG-11 with BatchNorm: bias-free 3×3 convs, each followed by a
    BatchNorm (the route of ``make_norm``) and ReLU, 2×2/s2 max-pools at
    'M', then a global mean. `remat` and `stem` are accepted and
    unused."""

    CFG = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")
    feature_dim = 512

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 in_channels: int = 3, remat: bool = False,
                 stem: str = "conv7", bn_impl: str = "pallas",
                 bn_stats_rows: int = 0, bn_stats_dtype: str = "float32",
                 image_size: int = None):
        super().__init__()
        norm = make_norm(bn_impl, bn_stats_rows, bn_stats_dtype, dtype)
        self.dtype = dtype
        self.spatial = None
        cin, k = in_channels, 0
        for v in self.CFG:
            if v != "M":
                self.add_module(f"conv{k}", Conv2d(cin, v, 3, 1, 1))
                self.add_module(f"bn{k}", norm(v))
                cin, k = v, k + 1

    def spatial_units(self):
        """(modules, fn(x, sp), chains of H windows) of each conv (with its
        BatchNorm) and pool (``parallel/spatial.py``)."""
        units, k = [], 0
        for v in self.CFG:
            if v == "M":
                units.append(((), lambda x, sp: _max_pool(x, 2, 2, 0, sp),
                              [[Window(2, 2, 0, 0)]]))
            else:
                conv, bn = getattr(self, f"conv{k}"), getattr(self, f"bn{k}")
                units.append(((conv, bn), lambda x, sp, conv=conv, bn=bn:
                              bn.act(conv(x, sp)), [[conv_window(conv)]]))
                k += 1
        return units

    def forward(self, x):
        return _run_units(self, x.to(self.dtype), self.spatial_units())


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """LeCun-normal over the fan in of `weight`'s rows, truncated at two
    standard deviations (flax's default kernel init), from `generator`."""
    # stddev of the unit normal truncated to [-2, 2] is 0.8796
    std = math.sqrt(1.0 / weight[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise like flax's defaults, from `generator`: conv and linear
    weights LeCun-normal (truncated at two standard deviations), biases 0,
    BatchNorm scale 1 / bias 0 / running mean 0 / running var 1. A module
    with a ``reset_parameters_(generator)`` method initialises its own
    parameters by it (the ViT's, ``models/vit.py``; the Swin's bias
    tables, ``models/swin.py``), in the same walk."""
    for m in module.modules():
        if hasattr(m, "reset_parameters_"):
            m.reset_parameters_(generator)
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNormBase):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


def resnet18(**kw):
    return ResNet(stage_sizes=(2, 2, 2, 2), block=BasicBlock, **kw)


def resnet34(**kw):
    return ResNet(stage_sizes=(3, 4, 6, 3), block=BasicBlock, **kw)


def resnet50(**kw):
    return ResNet(stage_sizes=(3, 4, 6, 3), block=Bottleneck, **kw)


def resnet101(**kw):
    return ResNet(stage_sizes=(3, 4, 23, 3), block=Bottleneck, **kw)


def resnet152(**kw):
    return ResNet(stage_sizes=(3, 8, 36, 3), block=Bottleneck, **kw)


def vit_l_16(**kw):
    """ViT-L/16 (``models/vit.py``, which builds on this module's
    ``Conv2d``)."""
    from .vit import vit_l_16 as build
    return build(**kw)


def swin_l(**kw):
    """Swin-L, window 12 (``models/swin.py``, which builds on this
    module's ``Conv2d``)."""
    from .swin import swin_l as build
    return build(**kw)


BACKBONES: dict = {
    "alexnet": AlexNet,
    "vgg11_bn": VGG11BN,
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
    "vit_l_16": vit_l_16,
    "swin_l": swin_l,
}


def make_trunk(backbone: str, **kw) -> nn.Module:
    """``BACKBONES[backbone](**kw)``; an unknown name raises ValueError."""
    if backbone not in BACKBONES:
        raise ValueError(f"unknown backbone {backbone!r}; expected one of "
                         f"{sorted(BACKBONES)}")
    return BACKBONES[backbone](**kw)
