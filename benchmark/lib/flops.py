"""Operations of ResNet-50, counted from its layer shapes: 2 for each
multiply-add of the convolutions and of the final linear layer. A train
step counts 3 forward passes (the forward, and the backward's two
products for the input and the weight gradients); recomputation is never
counted. BatchNorm, activations, pooling and the loss are left out.
"""

from __future__ import annotations

from ..reference.resnet import blocks, layer_shapes

#: dense bf16 peak of one NVIDIA H100 SXM (data sheet), at 700 W
H100_BF16_FLOPS = 989e12


def _out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def conv_outputs(image_size: int) -> dict:
    """conv name → output side, for a square image."""
    out = {}
    s = _out(image_size, 7, 2, 3)
    out["conv1"] = s
    s = _out(s, 3, 2, 1)
    for name, _, _, stride, proj in blocks():
        out[f"{name}.conv1"] = s
        s2 = _out(s, 3, stride, 1)
        out[f"{name}.conv2"] = s2
        out[f"{name}.conv3"] = s2
        if proj:
            out[f"{name}.downsample.0"] = s2
        s = s2
    return out


def resnet50_macs(image_size: int, n_out: int) -> int:
    """Multiply-adds of one image's forward pass."""
    convs, _ = layer_shapes()
    sides = conv_outputs(image_size)
    macs = sum(sides[k] ** 2 * co * ci * kh * kw
               for k, (co, ci, kh, kw) in convs.items())
    return macs + convs["layer4.2.conv3"][0] * n_out


def forward_flops(image_size: int, n_out: int) -> int:
    return 2 * resnet50_macs(image_size, n_out)


def train_flops(image_size: int, n_out: int) -> int:
    return 3 * forward_flops(image_size, n_out)


def bn_shapes(image_size: int):
    """(rows a image, channels) of each of the 53 BatchNorm layers, in
    forward order: each normalises its conv's output."""
    convs, norms = layer_shapes()
    sides = conv_outputs(image_size)
    conv_of = {"bn1": "conv1"}
    for name, *_ in blocks():
        for i in (1, 2, 3):
            conv_of[f"{name}.bn{i}"] = f"{name}.conv{i}"
        conv_of[f"{name}.downsample.1"] = f"{name}.downsample.0"
    return [(sides[conv_of[k]] ** 2, c) for k, c in norms.items()]
