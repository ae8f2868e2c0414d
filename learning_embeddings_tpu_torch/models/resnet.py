"""ResNet family in PyTorch: the port of ``learning_embeddings_tpu/models/
resnet.py`` (conv7 stem, train-mode BatchNorm through ``FusedBatchNorm``).

* Parameter names are torchvision's (conv1, bn1, layer{i}.{j}.conv{k} /
  bn{k} / downsample.{0,1}), so a JAX tree carried over by
  ``models/jax_import.py`` or a torchvision state dict loads as it is.
* Mixed precision as in flax's ``dtype=bfloat16, param_dtype=float32``:
  parameters are f32, the input is cast to `dtype` once, and each conv
  casts its weight to the activation dtype at use. The pooled features
  come out in f32. No autocast region is used, so the head stays f32.
* Layout: the caller passes NCHW tensors in channels_last memory (an NHWC
  batch ``permute(0, 3, 1, 2)`` is one), and the trainer puts the model in
  channels_last, so every BatchNorm input is a free (R, C) view.
* Padding: stem 7×7/s2 pad 3, max-pool 3×3/s2 pad 1 (with −inf), the
  stride of a bottleneck on its 3×3 conv, and a downsample branch exactly
  when the residual's shape changes.
"""

from __future__ import annotations

import math
from typing import Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bn import FusedBatchNorm

__all__ = [
    "BasicBlock",
    "Bottleneck",
    "ResNet",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "resnet152",
    "BACKBONES",
    "init_params_",
]


class Conv2d(nn.Conv2d):
    """Bias-free conv whose f32 weight is cast to the input's dtype."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=False)

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), None)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = Conv2d(cin, filters, 3, stride, 1)
        self.bn1 = FusedBatchNorm(filters, dtype=dtype)
        self.conv2 = Conv2d(filters, filters, 3, 1, 1)
        self.bn2 = FusedBatchNorm(filters, dtype=dtype)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.Sequential(
                Conv2d(cin, filters, 1, stride),
                FusedBatchNorm(filters, dtype=dtype))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cout = filters * self.expansion
        self.conv1 = Conv2d(cin, filters, 1)
        self.bn1 = FusedBatchNorm(filters, dtype=dtype)
        self.conv2 = Conv2d(filters, filters, 3, stride, 1)
        self.bn2 = FusedBatchNorm(filters, dtype=dtype)
        self.conv3 = Conv2d(filters, cout, 1)
        self.bn3 = FusedBatchNorm(cout, dtype=dtype)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride),
                FusedBatchNorm(cout, dtype=dtype))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """The trunk: returns the pooled f32 features (B, feature_dim), as the
    JAX ResNet does with ``features_only=True`` (heads live in
    ``models/heads.py``). `in_channels` is 1 for grayscale input."""

    def __init__(self, stage_sizes: Sequence[int], block: Type[nn.Module],
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        self.conv1 = Conv2d(in_channels, 64, 7, 2, 3)
        self.bn1 = FusedBatchNorm(64, dtype=dtype)
        cin = 64
        for i, n_blocks in enumerate(self.stage_sizes):
            blocks = []
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block(cin, 64 * 2**i, stride, dtype))
                cin = 64 * 2**i * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.feature_dim = cin

    def forward(self, x):
        x = x.to(self.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{i + 1}")(x)
        return x.mean(dim=(2, 3)).float()       # global average pool


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
        elif isinstance(m, FusedBatchNorm):
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
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
}
