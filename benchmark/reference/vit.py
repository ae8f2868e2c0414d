"""Plain Vision Transformer in float32, written out by hand (torchvision is
not installed): Dosovitskiy et al., "An Image is Worth 16x16 Words",
arXiv:2010.11929, ViT-L/16 and its smaller siblings by their shapes
(``Arch``), as the hierarchical classifier's trunk.

* Parameters are a dict of tensors under torchvision's ``vit_l_16``
  names with a ``trunk.`` prefix (``conv_proj``, ``class_token``,
  ``encoder.pos_embedding``, ``encoder.layers.encoder_layer_{i}.*``,
  ``encoder.ln``), plus the head's ``fc.weight`` / ``fc.bias``.
* The patch embedding is a conv of kernel and stride `patch`; the class
  token is prepended and the position embedding added; each block is
  ``x + out_proj(attn(LN1(x)))`` then ``x + mlp.3(gelu(mlp.0(LN2(x))))``
  (pre-LayerNorm, eps 1e-6, exact erf GELU); the attention is computed
  explicitly, softmax(q·kᵀ/√d)·v per head; a final LayerNorm, and the
  class token's row is the feature the head reads.
* No batch coupling: ``train_steps`` runs each step's batch in blocks of
  images and sums their gradients, the loss being the batch mean.

A rounding function ``q`` rounds where the program rounds to bf16: the
image, every weight at use, each linear, conv and LayerNorm output, q, k
and v, the attention's and the GELU's outputs, each residual sum. The
reference runs with the identity; ``fp8_round`` is the control. Matrix
products run in true float32 (``float32_math``: TF32 off). Nothing here
imports the measured package.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .resnet import (Adam, float32_math, identity, multi_level_ce,
                     scale_images)

EPS = 1e-6

Params = Dict[str, torch.Tensor]


class Arch(NamedTuple):
    image_size: int = 448
    patch: int = 16
    depth: int = 24
    width: int = 1024
    heads: int = 16
    mlp_dim: int = 4096

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch) ** 2 + 1


def layer_prefix(i: int) -> str:
    return f"trunk.encoder.layers.encoder_layer_{i}."


def shapes(arch: Arch, n_out: int, in_channels: int = 3
           ) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, in the program's order."""
    D, M = arch.width, arch.mlp_dim
    out = {"trunk.class_token": (1, 1, D),
           "trunk.conv_proj.weight": (D, in_channels, arch.patch,
                                      arch.patch),
           "trunk.conv_proj.bias": (D,),
           "trunk.encoder.pos_embedding": (1, arch.tokens, D)}
    for i in range(arch.depth):
        pre = layer_prefix(i)
        out.update({
            pre + "ln_1.weight": (D,), pre + "ln_1.bias": (D,),
            pre + "self_attention.in_proj_weight": (3 * D, D),
            pre + "self_attention.in_proj_bias": (3 * D,),
            pre + "self_attention.out_proj.weight": (D, D),
            pre + "self_attention.out_proj.bias": (D,),
            pre + "ln_2.weight": (D,), pre + "ln_2.bias": (D,),
            pre + "mlp.0.weight": (M, D), pre + "mlp.0.bias": (M,),
            pre + "mlp.3.weight": (D, M), pre + "mlp.3.bias": (D,)})
    out.update({"trunk.encoder.ln.weight": (D,),
                "trunk.encoder.ln.bias": (D,),
                "fc.weight": (n_out, D), "fc.bias": (n_out,)})
    return out


def leaves(name: str, t: torch.Tensor):
    """[(leaf, tensor)] of a parameter as the check reads it: the packed
    q, k, v projection (``in_proj_weight``, ``in_proj_bias``) as its three
    parts ``<name>.q``, ``.k``, ``.v``, every other parameter whole. The
    key bias's exact gradient is 0 (softmax over the keys does not see a
    bias added to every key), so Adam moves its entries by rounding
    alone, and as a leaf of its own the check leaves it out of the change
    (``lib/check.py::MOVED``)."""
    if name.endswith(("in_proj_weight", "in_proj_bias")):
        return [(f"{name}.{part}", c)
                for part, c in zip("qkv", t.chunk(3, dim=0))]
    return [(name, t)]


def leaf_norms(named) -> Dict[str, float]:
    """{leaf: norm} over (name, tensor) pairs, split by ``leaves``."""
    return {k: float(c.norm()) for name, t in named
            for k, c in leaves(name, t)}


def _linear(p: Params, name: str, x, q):
    return q(F.linear(x, q(p[name + ".weight"]), q(p[name + ".bias"])))


def _layer_norm(p: Params, name: str, x, q):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return q((x - mean) * torch.rsqrt(var + EPS) * q(p[name + ".weight"])
             + q(p[name + ".bias"]))


def _attention(p: Params, pre: str, x, heads: int, q):
    B, N, D = x.shape
    d = D // heads
    qkv = q(F.linear(x, q(p[pre + "in_proj_weight"]),
                     q(p[pre + "in_proj_bias"])))
    qq, kk, vv = qkv.view(B, N, 3, heads, d).permute(2, 0, 3, 1, 4)
    scores = qq @ kk.transpose(-2, -1) / math.sqrt(d)
    y = q(torch.softmax(scores, dim=-1) @ vv)
    return _linear(p, pre + "out_proj", y.transpose(1, 2).reshape(B, N, D),
                   q)


def _block(p: Params, i: int, heads: int, q):
    pre = layer_prefix(i)

    def run(x):
        x = q(x + _attention(p, pre + "self_attention.",
                             _layer_norm(p, pre + "ln_1", x, q), heads, q))
        h = q(F.gelu(_linear(p, pre + "mlp.0",
                             _layer_norm(p, pre + "ln_2", x, q), q)))
        return q(x + _linear(p, pre + "mlp.3", h, q))
    return run


def features(p: Params, images: torch.Tensor, arch: Arch,
             q: Callable = identity, recompute: bool = False):
    """The class token's features (B, width) of images (B, C, H, W) in
    [0, 1]. With `recompute` each block is recomputed in the backward
    pass (the same arithmetic, less memory)."""
    x = q(F.conv2d(q(images), q(p["trunk.conv_proj.weight"]),
                   q(p["trunk.conv_proj.bias"]), stride=arch.patch))
    B, D = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)
    cls = q(p["trunk.class_token"]).expand(B, -1, -1)
    x = q(torch.cat([cls, x], dim=1) + q(p["trunk.encoder.pos_embedding"]))
    for i in range(arch.depth):
        run = _block(p, i, arch.heads, q)
        x = checkpoint(run, x, use_reentrant=False) if recompute else run(x)
    return q(_layer_norm(p, "trunk.encoder.ln", x[:, 0], q))


def head(p: Params, feats: torch.Tensor) -> torch.Tensor:
    return F.linear(feats, p["fc.weight"], p["fc.bias"])


def train_steps(params0: Params,
                batches: Sequence[Tuple[np.ndarray, np.ndarray]],
                levels: Sequence[int], lr: float, device, arch: Arch,
                q: Callable = identity, block: int = 16) -> dict:
    """Follows len(batches) Adam steps from `params0` on (uint8 NHWC
    images, level labels) batches, each batch in blocks of `block` images
    whose gradients add up to the batch mean's. Returns {"losses",
    "grad_norms" (of the first step), "change_norms"} keyed by leaf
    (``leaves``)."""
    with float32_math():
        start = {k: v.to(device, torch.float32) for k, v in params0.items()}
        p = {k: v.clone() for k, v in start.items()}
        names = list(p)
        adam = Adam({k: lr for k in names})
        losses: List[float] = []
        grad_norms = None
        for images, level_labels in batches:
            n = len(images)
            grads = {k: torch.zeros_like(v) for k, v in p.items()}
            total = 0.0
            for i in range(0, n, block):
                for k in names:
                    p[k] = p[k].detach().requires_grad_(True)
                x = scale_images(torch.as_tensor(images[i:i + block])
                                 .to(device))
                ll = torch.as_tensor(np.asarray(level_labels[i:i + block]),
                                     dtype=torch.int64, device=device)
                feats = features(p, x, arch, q, recompute=True)
                # the block's share of the batch mean
                loss = multi_level_ce(head(p, feats), ll, levels) \
                    * (len(x) / n)
                g = torch.autograd.grad(loss, [p[k] for k in names])
                for k, gk in zip(names, g):
                    grads[k] += gk
                total += float(loss.detach())
                del x, feats, loss, g
            for k in names:
                p[k] = p[k].detach()
            if grad_norms is None:
                grad_norms = leaf_norms(grads.items())
            adam.step(p, grads)
            losses.append(total)
        change = leaf_norms((k, p[k] - start[k]) for k in names)
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
