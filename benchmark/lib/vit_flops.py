"""Operations of a ViT, counted from its shapes: 2 for each multiply-add
of the patch embedding, the linear layers (qkv, out_proj, the MLP's two,
the head) and the attention's two matrix products (q·kᵀ and p·v over
every head). A train step counts 3 forward passes (the forward, and the
backward's products for the inputs and the weights; the attention's
backward, which has no weights, is counted as twice its forward all the
same, as FlashAttention's papers count it); recomputation is never
counted. LayerNorm, GELU, softmax, the residual adds and the loss are
left out."""

from __future__ import annotations

from ..reference.vit import Arch


def patch_macs(arch: Arch, in_channels: int = 3) -> int:
    n = arch.tokens - 1
    return n * arch.width * in_channels * arch.patch ** 2


def linear_macs(arch: Arch) -> int:
    """The blocks' linear layers, every token."""
    D, M, N = arch.width, arch.mlp_dim, arch.tokens
    return arch.depth * N * (3 * D * D + D * D + 2 * D * M)


def attention_macs(arch: Arch) -> int:
    """q·kᵀ and p·v over every head of every block: 2·N²·D a block."""
    return arch.depth * 2 * arch.tokens ** 2 * arch.width


def vit_macs(arch: Arch, n_out: int) -> int:
    """Multiply-adds of one image's forward pass."""
    return (patch_macs(arch) + linear_macs(arch) + attention_macs(arch)
            + arch.width * n_out)


def forward_flops(arch: Arch, n_out: int) -> int:
    return 2 * vit_macs(arch, n_out)


def train_flops(arch: Arch, n_out: int) -> int:
    return 3 * forward_flops(arch, n_out)


def attention_train_flops(arch: Arch) -> int:
    """The attention's operations in one image's train step: 3 × 4·N²·D
    a block."""
    return 3 * 2 * attention_macs(arch)
