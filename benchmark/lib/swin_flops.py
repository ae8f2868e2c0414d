"""Operations and bytes of a Swin Transformer, counted from its shapes: 2
for each multiply-add of the patch embedding, the linear layers (qkv,
proj, the MLP's two, each patch merging's reduction, the head) and the
window attention's two matrix products (q·kᵀ and p·v over every window
and head). At 384² with window 12 Swin-L counts 103.92 G multiply-adds a
forward with a 1000-class head, the paper's 103.9 G (arXiv:2103.14030,
Table 1; its count adds the LayerNorms' 0.03 G). A train step counts 3
forward passes (the forward, and the backward's products for the inputs
and the weights; the attention's backward, which has no weights, is
counted as twice its forward all the same); recomputation is never
counted. LayerNorm, GELU, softmax, the bias, the shifts and partitions,
the residual adds and the loss are left out.

The window attention's own bounds, a block and image: FLOPs 3 × 4·N·T·C
(N tokens a window, T tokens of the stage, C its width); bytes 24·T·C
in bf16: q, k, v read and o written once in the forward; q, k, v, o and
dO read and dq, dk, dv written once in the backward. The bias table and
any bias made from it are not counted, so that the same work reads the
same whatever implements it.
"""

from __future__ import annotations

from ..reference.swin import Arch

#: HBM bandwidth of one NVIDIA H100 SXM (data sheet), bytes a second
H100_HBM_BYTES = 3.35e12
#: bytes of a bf16 value
BF16 = 2


def _blocks(arch: Arch):
    """(tokens T, width C, windows nW, window tokens N) of each block."""
    N = arch.window ** 2
    return [(g * g, C, g * g // N, N) for g, C, _, depth in arch.stages()
            for _ in range(depth)]


def patch_macs(arch: Arch, in_channels: int = 3) -> int:
    g, C = arch.image_size // arch.patch, arch.embed_dim
    return g * g * C * in_channels * arch.patch ** 2


def linear_macs(arch: Arch) -> int:
    """The blocks' linear layers and the patch merging, every token."""
    r = arch.mlp_ratio
    blocks = sum(T * (3 * C * C + C * C + 2 * r * C * C)
                 for T, C, _, _ in _blocks(arch))
    merging = sum((g // 2) ** 2 * 4 * C * 2 * C
                  for g, C, _, _ in arch.stages()[:-1])
    return blocks + merging


def attention_macs(arch: Arch) -> int:
    """q·kᵀ and p·v over every window and head of every block: 2·N·T·C a
    block."""
    return sum(2 * N * T * C for T, C, _, N in _blocks(arch))


def swin_macs(arch: Arch, n_out: int) -> int:
    """Multiply-adds of one image's forward pass."""
    return (patch_macs(arch) + linear_macs(arch) + attention_macs(arch)
            + arch.features * n_out)


def forward_flops(arch: Arch, n_out: int) -> int:
    return 2 * swin_macs(arch, n_out)


def train_flops(arch: Arch, n_out: int) -> int:
    return 3 * forward_flops(arch, n_out)


def attention_train_flops(arch: Arch) -> int:
    """The window attention's operations in one image's train step: 3 ×
    4·N·T·C a block."""
    return 3 * 2 * attention_macs(arch)


def attention_train_bytes(arch: Arch) -> int:
    """The window attention's bytes in one image's train step: 24·T·C a
    block (12 tensors of T·C in bf16)."""
    return sum(12 * BF16 * T * C for T, C, _, _ in _blocks(arch))
