"""Plain ResNet-50 in float32, written out by hand (torchvision is not
installed): He et al., "Deep Residual Learning for Image Recognition",
arXiv:1512.03385, with torchvision's widths and its stride on the 3×3 conv
of each bottleneck (v1.5).

* Parameters are a dict of tensors under torchvision's names with a
  ``trunk.`` prefix, plus the head's ``fc.weight`` / ``fc.bias``.
* BatchNorm in train mode normalises with the batch's mean and biased
  variance (eps 1e-5); in eval mode with the running statistics.
* The trunk's pooled features feed one linear layer (the multi-head
  classifier's logits over every taxonomy node, or the joint tower's
  projection).
* ``multi_level_ce``: per level, the cross entropy of that level's logit
  slice; summed over levels, averaged over the batch.
* ``Adam``: Adam (Kingma & Ba), b1 0.9, b2 0.999, eps 1e-8 added to the
  bias-corrected root.

A rounding function ``q`` rounds a tensor where a lower-precision
program would round it: the image, each conv weight and output, each
BatchNorm output, each residual sum and the pooled features. The
reference runs with the identity; ``fp8_round`` is the control's
rounding (per-tensor scaled e4m3 forward, e5m2 for the gradient);
``bf16_round`` the configurations' own precision.

Nothing here imports the measured package. Matrix products and
convolutions run in true float32: ``float32_math`` turns TF32 off while
the reference runs.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

STAGES = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)
EXPANSION = 4
STEM_WIDTH = 64
FEATURES = WIDTHS[-1] * EXPANSION
EPS = 1e-5

Params = Dict[str, torch.Tensor]


def blocks() -> Iterator[Tuple[str, int, int, int, bool]]:
    """(name, in channels, width, stride, has a projection shortcut) of the
    16 bottlenecks in order."""
    cin = STEM_WIDTH
    for i, n in enumerate(STAGES):
        for j in range(n):
            width = WIDTHS[i]
            stride = 2 if i > 0 and j == 0 else 1
            cout = width * EXPANSION
            yield (f"layer{i + 1}.{j}", cin, width, stride,
                   stride != 1 or cin != cout)
            cin = cout


def layer_shapes(in_channels: int = 3):
    """(convs, batch norms): conv name → (out, in, kh, kw) and BatchNorm
    name → channels, unprefixed, in forward order."""
    convs = {"conv1": (STEM_WIDTH, in_channels, 7, 7)}
    norms = {"bn1": STEM_WIDTH}
    for name, cin, width, _, proj in blocks():
        cout = width * EXPANSION
        convs[f"{name}.conv1"] = (width, cin, 1, 1)
        norms[f"{name}.bn1"] = width
        convs[f"{name}.conv2"] = (width, width, 3, 3)
        norms[f"{name}.bn2"] = width
        convs[f"{name}.conv3"] = (cout, width, 1, 1)
        norms[f"{name}.bn3"] = cout
        if proj:
            convs[f"{name}.downsample.0"] = (cout, cin, 1, 1)
            norms[f"{name}.downsample.1"] = cout
    return convs, norms


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _scaled_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x cast to an fp8 `dtype` and back, scaled per tensor so that its
    largest magnitude lands on the format's largest value."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _FP8(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        return _scaled_cast(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _scaled_cast(g, torch.float8_e5m2)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """The control's rounding: e4m3 forward, e5m2 backward."""
    return _FP8.apply(x)


class _BF16(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """bf16 rounding of values and gradients: the reference in the
    precision the configurations state, for a look at what that precision
    alone does to the check's numbers."""
    return _BF16.apply(x)


@contextlib.contextmanager
def float32_math():
    """True float32 matrix products and convolutions (TF32 off)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _conv(p: Params, name, x, stride, padding, q):
    return q(F.conv2d(x, q(p[f"trunk.{name}.weight"]), stride=stride,
                      padding=padding))


def _bn(p: Params, name, x, train: bool, q):
    pre = f"trunk.{name}."
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), correction=0)
    else:
        mean, var = p[pre + "running_mean"], p[pre + "running_var"]
    shape = (1, -1, 1, 1)
    y = ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + EPS)
         * p[pre + "weight"].view(shape) + p[pre + "bias"].view(shape))
    return q(y)


def _bottleneck(p, name, stride, proj, train, q):
    def run(x):
        y = F.relu(_bn(p, f"{name}.bn1", _conv(p, f"{name}.conv1", x, 1, 0,
                                                q), train, q))
        y = F.relu(_bn(p, f"{name}.bn2", _conv(p, f"{name}.conv2", y,
                                                stride, 1, q), train, q))
        y = _bn(p, f"{name}.bn3", _conv(p, f"{name}.conv3", y, 1, 0, q),
                train, q)
        r = x
        if proj:
            r = _bn(p, f"{name}.downsample.1",
                    _conv(p, f"{name}.downsample.0", x, stride, 0, q),
                    train, q)
        return F.relu(q(y + r))
    return run


def features(p: Params, images: torch.Tensor, train: bool,
             q: Callable = identity, recompute: bool = False):
    """Pooled features (B, 2048) of images (B, 3, H, W) in [0, 1]. With
    `recompute` each bottleneck is recomputed in the backward pass (the
    same arithmetic, less memory)."""
    x = q(images)
    x = F.relu(_bn(p, "bn1", _conv(p, "conv1", x, 2, 3, q), train, q))
    x = F.max_pool2d(x, 3, 2, 1)
    for name, _, _, stride, proj in blocks():
        run = _bottleneck(p, name, stride, proj, train, q)
        x = (checkpoint(run, x, use_reentrant=False) if recompute
             else run(x))
    return q(x.mean(dim=(2, 3)))


def head(p: Params, feats: torch.Tensor) -> torch.Tensor:
    return F.linear(feats, p["fc.weight"], p["fc.bias"])


def multi_level_ce(logits: torch.Tensor, level_labels: torch.Tensor,
                   levels) -> torch.Tensor:
    """Σ over levels of the cross entropy of each level's logit slice,
    averaged over the batch."""
    total, start = 0.0, 0
    for l, n in enumerate(levels):
        total = total + F.cross_entropy(logits[:, start:start + n],
                                        level_labels[:, l],
                                        reduction="none")
        start += n
    return total.mean()


def scale_images(u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 → (B, 3, H, W) f32 in [0, 1]."""
    return (u8.float() / 255.0).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def trainable(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


class Adam:
    """Plain Adam over a dict of leaves; the moments live beside them."""

    def __init__(self, lrs: Dict[str, float], b1=0.9, b2=0.999, eps=1e-8):
        self.lrs, self.b1, self.b2, self.eps = lrs, b1, b2, eps
        self.m, self.v, self.t = {}, {}, 0

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> None:
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        for k, g in grads.items():
            m = self.m.get(k, torch.zeros_like(g))
            v = self.v.get(k, torch.zeros_like(g))
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            self.m[k], self.v[k] = m, v
            params[k] -= self.lrs[k] * (m / bc1) / (torch.sqrt(v / bc2)
                                                   + self.eps)
