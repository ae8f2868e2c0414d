"""Hand-written Triton kernels for the train-mode BatchNorm reductions.

They replace the two Pallas kernels of the JAX package
(``learning_embeddings_tpu/ops/bn_pallas.py``):

* ``bn_stats``  ← ``_stats_kernel`` (bn_pallas.py:52-61, driven by
  ``_stats``, 81-99):   x (R, C)      → Σx, Σx²       (BN forward)
* ``bn_corr``   ← ``_corr_kernel``  (bn_pallas.py:64-74, driven by
  ``_corr``, 102-121):  dy, x (R, C)  → Σdy, Σ(dy·x)   (BN backward)

What bounds them on an H100: HBM bytes. Each is a column reduction over a
row-major, channel-minor (R = N·H·W, C) matrix with 2-3 flops per element
read and no matrix product, so tensor cores, ``wgmma`` and shared-memory
staging give nothing; the least time is the bytes read over the card's
memory rate.

Design, and how it differs from the TPU kernels:

* The TPU grid runs in order and carries the sums in its output block from
  one row block to the next; its row block must divide R (``_row_block``),
  else the JAX package falls back to XLA sums. Here the blocks of a 2-D
  grid (channel blocks × row splits) run in parallel and in no order. Each
  program walks a strided set of (BLOCK_R, BLOCK_C) tiles, loads them
  coalesced along C, upcasts to f32 and accumulates in registers, then
  writes one partial row into a (2, n_splits, C) f32 workspace. A
  ``torch.sum`` over the few-KB partials finishes the reduction: the
  result does not depend on scheduling (no atomics), so it is the same
  from run to run.
* The R and C tails are masked, so any (R, C) runs on the kernel; there is
  no fallback on the card.
* ``n_splits`` is chosen so that the grid holds a few programs per SM for
  the smallest ResNet-50@448 shape (R = 196·B, C = 2048) as for the
  largest (R = 50176·B, C = 64).

Not yet done (later work, with its times in PERF.md): TMA bulk loads,
persistent programs, fusing the normalisation and the dx epilogue.

``triton`` is imported, and the kernels are built, on the first launch
only: this module imports on a host with no Triton. The compiled kernels
are cached under ``<checkout>/.torch_kernels/triton`` (gitignored) unless
``TRITON_CACHE_DIR`` says otherwise.

``bn_stats(x2, round_sq=True)`` is the variant that the bf16 statistics of
the JAX package's ``GhostBatchNorm`` (``models/resnet.py:88-93``) need:
each x² is rounded to bf16 before it is summed, as ``xs * xs`` rounds in
a bf16 array, through a ``constexpr`` switch of the same kernel.

Each wrapper adds one to its launch count (``STATS_LAUNCHES``,
``CORR_LAUNCHES``) where it launches its kernel, and nowhere else; a
launch of the rounding variant also counts in ``STATS_ROUNDED_LAUNCHES``.
"""

import contextlib
import functools
import os

import torch

os.environ.setdefault(
    "TRITON_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".torch_kernels", "triton"))

__all__ = ["bn_stats", "bn_corr", "STATS_LAUNCHES", "CORR_LAUNCHES",
           "STATS_ROUNDED_LAUNCHES"]

#: launches of the bn_stats / bn_corr kernels since import (or last reset)
STATS_LAUNCHES = 0
CORR_LAUNCHES = 0
#: the bn_stats launches with round_sq=True (also counted in STATS_LAUNCHES)
STATS_ROUNDED_LAUNCHES = 0

#: elements of one (BLOCK_R, BLOCK_C) tile: 2 f32 accumulators of this size
#: over 4 warps keep the register use near 130 a thread
_TILE_ELEMS = 4096
_NUM_WARPS = 4
#: programs per SM the row splits aim for
_PROGRAMS_PER_SM = 4

_KERNELS = None
tl = None   # triton.language, bound on the first launch (see _kernels)


def _kernels():
    """Build (once) and return the two jitted kernels."""
    global _KERNELS, tl
    if _KERNELS is not None:
        return _KERNELS
    import triton
    import triton.language as tl

    @triton.jit
    def bn_stats_kernel(x_ptr, part_ptr, R, C,
                        BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
                        ROUND_SQ: tl.constexpr):
        pid_c = tl.program_id(0)
        pid_s = tl.program_id(1)
        n_splits = tl.num_programs(1)
        cols = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        acc_s = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
        acc_q = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
        for r0 in range(pid_s * BLOCK_R, R, n_splits * BLOCK_R):
            rows = r0 + tl.arange(0, BLOCK_R)
            mask = (rows < R)[:, None] & cmask[None, :]
            offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            acc_s += x
            if ROUND_SQ:   # x² rounded to bf16 (nearest even), then summed
                acc_q += (x * x).to(tl.bfloat16).to(tl.float32)
            else:
                acc_q += x * x
        out = pid_s * C + cols
        tl.store(part_ptr + out, tl.sum(acc_s, axis=0), mask=cmask)
        tl.store(part_ptr + n_splits * C + out, tl.sum(acc_q, axis=0),
                 mask=cmask)

    @triton.jit
    def bn_corr_kernel(dy_ptr, x_ptr, part_ptr, R, C,
                       BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        pid_c = tl.program_id(0)
        pid_s = tl.program_id(1)
        n_splits = tl.num_programs(1)
        cols = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        acc_s = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
        acc_p = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
        for r0 in range(pid_s * BLOCK_R, R, n_splits * BLOCK_R):
            rows = r0 + tl.arange(0, BLOCK_R)
            mask = (rows < R)[:, None] & cmask[None, :]
            offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
            dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            acc_s += dy
            acc_p += dy * x
        out = pid_s * C + cols
        tl.store(part_ptr + out, tl.sum(acc_s, axis=0), mask=cmask)
        tl.store(part_ptr + n_splits * C + out, tl.sum(acc_p, axis=0),
                 mask=cmask)

    _KERNELS = (bn_stats_kernel, bn_corr_kernel)
    return _KERNELS


def launch_shape(R: int, C: int, n_sms: int):
    """(BLOCK_R, BLOCK_C, n_splits) for an (R, C) input on a card with
    `n_sms` SMs: channel blocks of up to 128 lanes, 4096-element tiles, and
    enough row splits for `_PROGRAMS_PER_SM` programs per SM (never more
    splits than row blocks)."""
    block_c = min(128, max(16, 1 << (C - 1).bit_length()))
    block_r = _TILE_ELEMS // block_c
    n_cblocks = -(-C // block_c)
    row_blocks = -(-R // block_r)
    want = -(-(_PROGRAMS_PER_SM * n_sms) // n_cblocks)
    return block_r, block_c, max(1, min(row_blocks, want))


def _check(name: str, *ts: torch.Tensor):
    R, C = ts[0].shape if ts[0].ndim == 2 else (None, None)
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.ndim != 2 or tuple(t.shape) != (R, C):
            raise ValueError(f"{name}: expected matching (R, C) matrices, "
                             f"got {[tuple(u.shape) for u in ts]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a row-major contiguous "
                             f"(R, C) matrix, got strides {t.stride()}")
        if t.dtype not in (torch.bfloat16, torch.float16, torch.float32):
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
    if R == 0 or C == 0:
        raise ValueError(f"{name}: empty input {(R, C)}")
    return R, C


@functools.lru_cache(maxsize=256)
def _geometry(R: int, C: int, device_index: int):
    n_sms = torch.cuda.get_device_properties(device_index) \
        .multi_processor_count
    block_r, block_c, n_splits = launch_shape(R, C, n_sms)
    return block_r, block_c, n_splits, (-(-C // block_c), n_splits)


def _launch(kernel, name: str, *ts: torch.Tensor, **constexprs):
    R, C = _check(name, *ts)
    dev = ts[0].device
    block_r, block_c, n_splits, grid = _geometry(R, C, dev.index)
    part = torch.empty((2, n_splits, C), device=dev, dtype=torch.float32)
    # Triton launches on the current device: switch only when it differs
    same = dev.index == torch.cuda.current_device()
    guard = contextlib.nullcontext() if same else torch.cuda.device(dev)
    with guard:
        kernel[grid](*ts, part, R, C, BLOCK_R=block_r, BLOCK_C=block_c,
                     num_warps=_NUM_WARPS, **constexprs)
    first, second = part.sum(dim=1)
    return first, second


def bn_stats(x2: torch.Tensor, round_sq: bool = False):
    """Σx and Σx² over the rows of a CUDA (R, C) matrix, in f32; with
    `round_sq` each x² is rounded to bf16 before the sum."""
    global STATS_LAUNCHES, STATS_ROUNDED_LAUNCHES
    stats_kernel, _ = _kernels()
    out = _launch(stats_kernel, "bn_stats", x2, ROUND_SQ=bool(round_sq))
    STATS_LAUNCHES += 1
    STATS_ROUNDED_LAUNCHES += bool(round_sq)
    return out


def bn_corr(dy2: torch.Tensor, x2: torch.Tensor):
    """Σdy and Σ(dy·x) over the rows of two CUDA (R, C) matrices, in f32."""
    global CORR_LAUNCHES
    _, corr_kernel = _kernels()
    out = _launch(corr_kernel, "bn_corr", dy2, x2)
    CORR_LAUNCHES += 1
    return out
