"""What the benchmark makes from ``--seed`` and hands to both the program
and the reference: weights, images, leaves and edges.

Every stream has a seed of its own, derived from the run's seed and a
tag, so that adding a stream changes no other. Tensors are drawn on the
run's device by a ``torch.Generator`` of that device, in a few large
calls; host arrays come from ``np.random.RandomState``.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict

import numpy as np
import torch

from ..reference.resnet import FEATURES, layer_shapes


def sub_seed(seed: int, tag: str) -> int:
    """A 31-bit seed for the stream `tag` of run `seed` (any whole
    number)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), zlib.crc32(
        tag.encode())])
    return int(ss.generate_state(1, np.uint32)[0] >> 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def rng(seed: int, tag: str) -> np.random.RandomState:
    return np.random.RandomState(sub_seed(seed, tag))


def resnet_params(seed: int, device, n_out: int, tag: str = "weights",
                  running_stats: bool = False) -> Dict[str, torch.Tensor]:
    """f32 ResNet-50 weights under the program's names (``trunk.*``,
    ``fc.*``): conv and linear weights normal with std 1/sqrt(fan_in),
    cut at two standard deviations; BatchNorm scales 1 + 0.1·N, biases
    0.1·N; with `running_stats` running means 0.1·N and variances
    1 + 0.25·|N|, else 0 and 1."""
    gen = generator(seed, tag, device)
    convs, norms = layer_shapes()
    shapes = {f"trunk.{k}.weight": s for k, s in convs.items()}
    shapes["fc.weight"] = (n_out, FEATURES)
    total = sum(math.prod(s) for s in shapes.values())
    z = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, s in shapes.items():
        n = math.prod(s)
        fan_in = n // s[0]
        out[name] = z[at:at + n].view(s) / math.sqrt(fan_in) / 0.8796256610
        at += n
    channels = sum(norms.values())
    u = torch.randn((5, channels), generator=gen, device=device)
    at = 0
    for name, c in norms.items():
        v = u[:, at:at + c]
        at += c
        out[f"trunk.{name}.weight"] = 1.0 + 0.1 * v[0]
        out[f"trunk.{name}.bias"] = 0.1 * v[1]
        if running_stats:
            out[f"trunk.{name}.running_mean"] = 0.1 * v[2]
            out[f"trunk.{name}.running_var"] = 1.0 + 0.25 * v[3].abs()
        else:
            out[f"trunk.{name}.running_mean"] = torch.zeros_like(v[2])
            out[f"trunk.{name}.running_var"] = torch.ones_like(v[3])
    out["fc.bias"] = 0.1 * torch.randn(n_out, generator=gen, device=device)
    return {k: v.contiguous() for k, v in out.items()}


def label_table(seed: int, device, n_labels: int, dim: int,
                r0: float) -> torch.Tensor:
    """(n_labels, dim) rows with N(0, 1) directions at norms r0 + U[0,
    0.05] (the hyperbolic label table's start)."""
    gen = generator(seed, "labels", device)
    x = torch.randn((n_labels, dim), generator=gen, device=device)
    r = r0 + 0.05 * torch.rand((n_labels, 1), generator=gen, device=device)
    return x / x.norm(dim=1, keepdim=True) * r


def uint8_images(seed: int, tag: str, n: int, size: int,
                 device) -> np.ndarray:
    """(n, size, size, 3) uint8 host images, drawn on `device`."""
    gen = generator(seed, tag, device)
    t = torch.randint(0, 256, (n, size, size, 3), dtype=torch.uint8,
                      generator=gen, device=device)
    return t.cpu().numpy()


def joint_edges(paths_global: np.ndarray, n_labels: int) -> np.ndarray:
    """The joint graph's training edges (E, 2): every label→label edge
    between adjacent levels that the images' paths show, then every
    label→image edge from each level of each image's path (image i is
    node n_labels + i)."""
    L = paths_global.shape[1]
    label = np.unique(np.concatenate([paths_global[:, l:l + 2]
                                      for l in range(L - 1)]), axis=0)
    n = len(paths_global)
    image = np.stack([paths_global.reshape(-1),
                      np.repeat(n_labels + np.arange(n), L)], axis=1)
    return np.concatenate([label, image]).astype(np.int64)
