"""The backbone zoo in PyTorch: the port of ``learning_embeddings_tpu/
models/resnet.py`` (ResNet-18 to -152, ``AlexNet``, ``VGG11BN``).

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
* ``stem='s2d'``: space-to-depth(2), channels in the JAX package's order
  (u·2 + v)·C + c (``F.pixel_unshuffle`` orders them c·4 + u·2 + v), then
  a 4×4/s1 conv after an asymmetric (2, 1) ``F.pad``: the exact
  reparametrisation of the 7×7/s2/p3 stem (``s2d_stem_kernel``).
* ``remat=True``: each residual block runs under ``torch.utils.checkpoint``
  (non-reentrant) and is recomputed in the backward pass, the stem is not;
  the recompute leaves the BatchNorm running statistics alone (see
  ``ops/bn.py``). AlexNet and VGG11BN take `remat` and `stem` for a
  uniform signature and ignore them, as the JAX package's do.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.bn import BatchNormBase, make_norm

__all__ = [
    "BasicBlock",
    "Bottleneck",
    "ResNet",
    "AlexNet",
    "VGG11BN",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "resnet152",
    "BACKBONES",
    "STEMS",
    "make_trunk",
    "init_params_",
    "space_to_depth",
    "s2d_stem_kernel",
]

STEMS = ("conv7", "s2d")


class Conv2d(nn.Conv2d):
    """Conv whose f32 weight (and bias) is cast to the input's dtype."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, bias=False):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=bias)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


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

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


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

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


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
                 bn_stats_dtype: str = "float32"):
        super().__init__()
        if stem not in STEMS:
            raise ValueError(f"unknown stem {stem!r}; expected {STEMS}")
        norm = make_norm(bn_impl, bn_stats_rows, bn_stats_dtype, dtype)
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
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

    def forward(self, x):
        x = x.to(self.dtype)
        if self.stem == "s2d":
            x = F.pad(space_to_depth(x), (2, 1, 2, 1))
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for i in range(len(self.stage_sizes)):
            for blk in getattr(self, f"layer{i + 1}"):
                if remat:
                    x = checkpoint(
                        blk, x, use_reentrant=False, preserve_rng_state=False,
                        context_fn=lambda blk=blk: (contextlib.nullcontext(),
                                                    _recomputing(blk)))
                else:
                    x = blk(x)
        return x.mean(dim=(2, 3)).float()       # global average pool


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
                 bn_stats_rows: int = 0, bn_stats_dtype: str = "float32"):
        super().__init__()
        self.dtype = dtype
        cin = in_channels
        for k, (filters, kernel, stride, _) in enumerate(self.LAYERS):
            self.add_module(f"conv{k}", Conv2d(cin, filters, kernel, stride,
                                               kernel // 2, bias=True))
            cin = filters
        self.dense0 = nn.Linear(cin, 4096)
        self.dense1 = nn.Linear(4096, 4096)

    def forward(self, x):
        x = x.to(self.dtype)
        for k, (_, _, _, pool) in enumerate(self.LAYERS):
            x = F.relu(getattr(self, f"conv{k}")(x))
            if pool:
                x = F.max_pool2d(x, 3, 2)
        x = x.mean(dim=(2, 3)).float()
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
                 bn_stats_rows: int = 0, bn_stats_dtype: str = "float32"):
        super().__init__()
        norm = make_norm(bn_impl, bn_stats_rows, bn_stats_dtype, dtype)
        self.dtype = dtype
        cin, k = in_channels, 0
        for v in self.CFG:
            if v != "M":
                self.add_module(f"conv{k}", Conv2d(cin, v, 3, 1, 1))
                self.add_module(f"bn{k}", norm(v))
                cin, k = v, k + 1

    def forward(self, x):
        x = x.to(self.dtype)
        k = 0
        for v in self.CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"bn{k}")(
                    getattr(self, f"conv{k}")(x)))
                k += 1
        return x.mean(dim=(2, 3)).float()


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise like flax's defaults, from `generator`: conv and linear
    weights LeCun-normal (truncated at two standard deviations), biases 0,
    BatchNorm scale 1 / bias 0 / running mean 0 / running var 1."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            # stddev of the unit normal truncated to [-2, 2] is 0.8796
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
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


BACKBONES: dict = {
    "alexnet": AlexNet,
    "vgg11_bn": VGG11BN,
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
}


def make_trunk(backbone: str, **kw) -> nn.Module:
    """``BACKBONES[backbone](**kw)``; an unknown name raises ValueError."""
    if backbone not in BACKBONES:
        raise ValueError(f"unknown backbone {backbone!r}; expected one of "
                         f"{sorted(BACKBONES)}")
    return BACKBONES[backbone](**kw)
