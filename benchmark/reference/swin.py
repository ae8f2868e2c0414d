"""Plain Swin Transformer in float32, written out by hand (torchvision is
not installed): Liu et al., "Swin Transformer: Hierarchical Vision
Transformer using Shifted Windows", arXiv:2103.14030, Swin-L (window 12)
and its smaller siblings by their shapes (``Arch``), as the hierarchical
classifier's trunk.

* Parameters are a dict of tensors under torchvision's ``swin_b`` names
  with a ``trunk.`` prefix (``features.0.0`` the patch conv,
  ``features.0.2`` its LayerNorm, ``features.{1,3,5,7}.{j}.*`` the
  blocks, ``features.{2,4,6}.{norm, reduction}`` the patch merging,
  ``norm``), plus the head's ``fc.weight`` / ``fc.bias``.
* §3.1: the patch embedding is a conv of kernel and stride `patch`, then
  LayerNorm; each block is ``x + proj(attn(LN1(x)))`` within windows,
  then ``x + mlp.3(gelu(mlp.0(LN2(x))))`` (pre-LayerNorm, eps 1e-5,
  exact erf GELU); patch merging concatenates each 2×2 neighbourhood
  (torchvision's order: (0, 0), (1, 0), (0, 1), (1, 1) in (row,
  column)), then LayerNorm(4C) and a linear map to 2C without bias; a
  final LayerNorm and the mean over the grid are the features.
* §3.2, from the equations, not from the program: the shifted block's
  cyclic shift moves the grid ⌊M/2⌋ tokens towards the top left
  (token (y, x) of the shifted grid is token ((y + s) mod G, (x + s) mod
  G) of the stream) and cuts it into M × M windows, both by one index
  gather, undone by the inverse gather; the mask gives −100 to each pair
  of a window whose tokens lie, on the shifted grid, in different
  regions of the split of each axis at G − M and G − s; the relative
  position bias of tokens i = (yi, xi) and j of a window is the table's
  row (yi − yj + M − 1)·(2M − 1) + (xi − xj + M − 1). A grid of one
  window does not shift (§3.2; the last stage at 384²).
* The attention is computed explicitly per window and head:
  softmax(q·kᵀ/√d + B + M)·v.
* No batch coupling: ``train_steps`` runs each step's batch in blocks of
  images and sums their gradients, the loss being the batch mean.

Departures from the paper: none in the shapes. The classifier's head
reads the mean-pooled features, as the paper's does; no dropout and no
stochastic depth (the benchmark's configuration fine-tunes without
them); the mask's −100 is the official code's and torchvision's value
(the paper says only that the masked pairs are excluded).

A rounding function ``q`` rounds where the program rounds to bf16: the
image, every weight at use, each linear, conv and LayerNorm output, the
summed bias B + M, q, k and v, the attention's and the GELU's outputs,
each residual sum. The reference runs with the identity; ``fp8_round``
is the control. Matrix products run in true float32 (``float32_math``:
TF32 off). Nothing here imports the measured package.
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

EPS = 1e-5
MASKED = -100.0
#: the name of each block's relative-bias table ends so
TABLE = "relative_position_bias_table"

Params = Dict[str, torch.Tensor]


class Arch(NamedTuple):
    image_size: int = 384
    patch: int = 4
    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    heads: Tuple[int, ...] = (6, 12, 24, 48)
    window: int = 12
    mlp_ratio: int = 4

    def stages(self) -> List[Tuple[int, int, int, int]]:
        """(grid side, width, heads, depth) of each stage."""
        g = self.image_size // self.patch
        return [(g >> i, self.embed_dim << i, h, d) for i, (h, d) in
                enumerate(zip(self.heads, self.depths))]

    @property
    def features(self) -> int:
        return self.embed_dim << (len(self.depths) - 1)


def stage_prefix(i: int) -> str:
    """The blocks of stage i (0-based) are ``features.{2i + 1}``."""
    return f"trunk.features.{2 * i + 1}."


def shapes(arch: Arch, n_out: int, in_channels: int = 3
           ) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, in the program's order."""
    C, P, M = arch.embed_dim, arch.patch, arch.window
    out = {"trunk.features.0.0.weight": (C, in_channels, P, P),
           "trunk.features.0.0.bias": (C,),
           "trunk.features.0.2.weight": (C,),
           "trunk.features.0.2.bias": (C,)}
    for i, (_, D, H, depth) in enumerate(arch.stages()):
        if i:
            pre = f"trunk.features.{2 * i}."
            out.update({pre + "norm.weight": (2 * D,),
                        pre + "norm.bias": (2 * D,),
                        pre + "reduction.weight": (D, 2 * D)})
        R = arch.mlp_ratio * D
        for j in range(depth):
            pre = f"{stage_prefix(i)}{j}."
            out.update({
                pre + "norm1.weight": (D,), pre + "norm1.bias": (D,),
                pre + "attn.relative_position_bias_table":
                    ((2 * M - 1) ** 2, H),
                pre + "attn.qkv.weight": (3 * D, D),
                pre + "attn.qkv.bias": (3 * D,),
                pre + "attn.proj.weight": (D, D),
                pre + "attn.proj.bias": (D,),
                pre + "norm2.weight": (D,), pre + "norm2.bias": (D,),
                pre + "mlp.0.weight": (R, D), pre + "mlp.0.bias": (R,),
                pre + "mlp.3.weight": (D, R), pre + "mlp.3.bias": (D,)})
    F_ = arch.features
    out.update({"trunk.norm.weight": (F_,), "trunk.norm.bias": (F_,),
                "fc.weight": (n_out, F_), "fc.bias": (n_out,)})
    return out


def leaves(name: str, t: torch.Tensor):
    """[(leaf, tensor)] of a parameter as the check reads it: the packed
    q, k, v projection (``attn.qkv.weight``, ``attn.qkv.bias``) as its
    three parts ``<name>.q``, ``.k``, ``.v``, every other parameter whole.
    The key bias's exact gradient is 0 (softmax over the keys does not see
    a bias added to every key, with or without B + M), so Adam moves its
    entries by rounding alone, and as a leaf of its own the check leaves
    it out of the change (``lib/check.py::MOVED``)."""
    if name.endswith(("attn.qkv.weight", "attn.qkv.bias")):
        return [(f"{name}.{part}", c)
                for part, c in zip("qkv", t.chunk(3, dim=0))]
    return [(name, t)]


def leaf_norms(named) -> Dict[str, float]:
    """{leaf: norm} over (name, tensor) pairs, split by ``leaves``."""
    return {k: float(c.norm()) for name, t in named
            for k, c in leaves(name, t)}


# ---------------------------------------------------------------------------
# §3.2: the windows, the shift, the mask and the relative index
# ---------------------------------------------------------------------------

def window_gather(grid: int, window: int, shift: int) -> np.ndarray:
    """(nW·N,) flat grid positions: entry (w·N + i·M + j) is the stream's
    token at row (wy·M + i + s) mod G and column (wx·M + j + s) mod G,
    window w = wy·(G/M) + wx."""
    n = grid // window
    out = np.empty((n, n, window, window), np.int64)
    for wy in range(n):
        for wx in range(n):
            for i in range(window):
                for j in range(window):
                    y = (wy * window + i + shift) % grid
                    x = (wx * window + j + shift) % grid
                    out[wy, wx, i, j] = y * grid + x
    return out.reshape(-1)


def region_mask(grid: int, window: int, shift: int) -> np.ndarray:
    """(nW, N, N): −100 where two tokens of a window lie in different
    regions of the shifted grid, each axis split at G − M and G − s; 0
    elsewhere (everywhere when `shift` is 0)."""
    n = grid // window

    def part(c):
        return 0 if c < grid - window else (1 if c < grid - shift else 2)
    out = np.zeros((n * n, window * window, window * window), np.float32)
    if not shift:
        return out
    for wy in range(n):
        for wx in range(n):
            region = np.array([3 * part(wy * window + i)
                               + part(wx * window + j)
                               for i in range(window)
                               for j in range(window)])
            out[wy * n + wx] = np.where(region[:, None] != region[None, :],
                                        MASKED, 0.0)
    return out


def relative_index(window: int) -> np.ndarray:
    """(N, N): table row of each pair of a window's tokens."""
    N = window * window
    out = np.empty((N, N), np.int64)
    for a in range(N):
        ya, xa = divmod(a, window)
        for b in range(N):
            yb, xb = divmod(b, window)
            out[a, b] = ((ya - yb + window - 1) * (2 * window - 1)
                         + (xa - xb + window - 1))
    return out


class _Geometry:
    """The index tensors of each (grid, window, shift), made once."""

    def __init__(self):
        self.cache = {}

    def __call__(self, grid, window, shift, device):
        key = (grid, window, shift, str(device))
        if key not in self.cache:
            g = window_gather(grid, window, shift)
            self.cache[key] = (
                torch.as_tensor(g, device=device),
                torch.as_tensor(np.argsort(g), device=device),
                torch.as_tensor(region_mask(grid, window, shift),
                                device=device),
                torch.as_tensor(relative_index(window), device=device))
        return self.cache[key]


GEOMETRY = _Geometry()


# ---------------------------------------------------------------------------
# the trunk
# ---------------------------------------------------------------------------

def _linear(p: Params, name: str, x, q, bias: bool = True):
    return q(F.linear(x, q(p[name + ".weight"]),
                      q(p[name + ".bias"]) if bias else None))


def _layer_norm(p: Params, name: str, x, q):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return q((x - mean) * torch.rsqrt(var + EPS) * q(p[name + ".weight"])
             + q(p[name + ".bias"]))


def _window_attention(p: Params, pre: str, x, grid: int, window: int,
                      shift: int, heads: int, q):
    """(B, G·G, C) → (B, G·G, C): the (shifted) window attention."""
    B, T, C = x.shape
    gather, scatter, mask, rel = GEOMETRY(grid, window, shift, x.device)
    N, d = window * window, C // heads
    nW = T // N
    win = x[:, gather].view(B, nW, N, C)
    qkv = q(F.linear(win, q(p[pre + "qkv.weight"]), q(p[pre + "qkv.bias"])))
    qq, kk, vv = qkv.view(B, nW, N, 3, heads, d).permute(3, 0, 1, 4, 2, 5)
    table = p[pre + "relative_position_bias_table"]            # (R, H)
    bias = q(table[rel].permute(2, 0, 1)[None] + mask[:, None])  # nW,H,N,N
    scores = qq @ kk.transpose(-2, -1) / math.sqrt(d) + bias
    y = q(torch.softmax(scores, dim=-1) @ vv)                  # B,nW,H,N,d
    y = _linear(p, pre + "proj", y.transpose(2, 3).reshape(B, nW, N, C), q)
    return y.reshape(B, T, C)[:, scatter]


def _block(p: Params, pre: str, grid: int, window: int, shift: int,
           heads: int, q):
    def run(x):
        x = q(x + _window_attention(p, pre + "attn.",
                                    _layer_norm(p, pre + "norm1", x, q),
                                    grid, window, shift, heads, q))
        h = q(F.gelu(_linear(p, pre + "mlp.0",
                             _layer_norm(p, pre + "norm2", x, q), q)))
        return q(x + _linear(p, pre + "mlp.3", h, q))
    return run


def _merge(p: Params, pre: str, x, grid: int, q):
    """(B, G·G, C) → (B, (G/2)², 2C)."""
    B, _, C = x.shape
    x = x.view(B, grid, grid, C)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], dim=-1).reshape(B, -1, 4 * C)
    return _linear(p, pre + "reduction", _layer_norm(p, pre + "norm", x, q),
                   q, bias=False)


def features(p: Params, images: torch.Tensor, arch: Arch,
             q: Callable = identity, recompute: bool = False):
    """The pooled features (B, 8C) of images (B, C, H, W) in [0, 1]. With
    `recompute` each block is recomputed in the backward pass (the same
    arithmetic, less memory)."""
    x = q(F.conv2d(q(images), q(p["trunk.features.0.0.weight"]),
                   q(p["trunk.features.0.0.bias"]), stride=arch.patch))
    x = _layer_norm(p, "trunk.features.0.2", x.flatten(2).transpose(1, 2),
                    q)
    for i, (grid, _, heads, depth) in enumerate(arch.stages()):
        if i:
            x = _merge(p, f"trunk.features.{2 * i}.", x, 2 * grid, q)
        shifted = arch.window // 2 if grid > arch.window else 0
        for j in range(depth):
            run = _block(p, f"{stage_prefix(i)}{j}.", grid, arch.window,
                         shifted if j % 2 else 0, heads, q)
            x = checkpoint(run, x, use_reentrant=False) if recompute \
                else run(x)
    return _layer_norm(p, "trunk.norm", x, q).mean(dim=1)


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
    (``leaves``), and "table_grads": each relative-bias table's first
    gradient (a tensor on the CPU)."""
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
                table_grads = {k: grads[k].cpu() for k in names
                               if k.endswith(TABLE)}
            adam.step(p, grads)
            losses.append(total)
        change = leaf_norms((k, p[k] - start[k]) for k in names)
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "table_grads": table_grads}
