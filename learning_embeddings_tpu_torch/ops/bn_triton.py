"""Hand-written Triton kernels for the train-mode BatchNorm.

Two replace the Pallas kernels of the JAX package
(``learning_embeddings_tpu/ops/bn_pallas.py``):

* ``bn_stats``  ← ``_stats_kernel`` (bn_pallas.py:52-61, driven by
  ``_stats``, 81-99):   x (R, C)      → Σx, Σx²       (BN forward)
* ``bn_corr``   ← ``_corr_kernel``  (bn_pallas.py:64-74, driven by
  ``_corr``, 102-121):  dy, x (R, C)  → Σdy, Σ(dy·x)   (BN backward)

The third, ``bn_dx`` (``bn_dx_kernel``: dy, x (R, C) and K2's sums → dx,
and the scale's gradient), replaces no TPU kernel: the JAX package leaves
dx to XLA (``_bn_bwd_vjp``, bn_pallas.py:150-170), which fuses its
elementwise passes. Eager PyTorch does not, and the same dx written as
plain tensor code made ~9 f32 passes over every activation (~70 bytes an
element). See "dx" below.

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

dx: what bounds ``bn_dx`` is HBM bytes too: dy and x read once and dx
written once, 6 bytes an element in bf16, against ~8 f32 operations. Every
per-channel coefficient (from the (C,) vectors of the forward and K2) is
computed in each program's prologue, for its own channel block, so the
backward epilogue is one launch; dx is a streaming pass over the same 2-D
grid of channel blocks × row splits (no accumulator is carried, so its
tiles are larger), computed in f32 registers and rounded once to x's
dtype at the store. One expression serves the plain and the ghost routes
(``ops/bn.py::_dx_plain`` spells it out); the row split 0 programs also
write the scale's gradient. It writes a separate output, never into dy
(autograd hands the same gradient to both branches of a residual add).

The fourth, ``bn_act`` (``bn_act_kernel``: x (R, C), optionally a
residual r (R, C), and the per-channel sums or running statistics →
act(x·a + b [+ r])), replaces no TPU kernel either: the JAX package
leaves the normalisation, ReLU and residual add to XLA, which fuses them
into the convolution's epilogue. Eager PyTorch ran them as ~13 tiny f32
launches for the fold of a and b, ATen's strided ``addcmul`` (the
per-channel broadcast over a channels_last tensor), a residual ``add``
and a ReLU ``clamp``, each writing its bf16 result to HBM and the next
reading it back. What bounds the fused pass: HBM bytes, x (and r) read
once and the output written once, 4 (6) bytes an element in bf16. Its
prologue folds each channel block's coefficients in f32 from the (C,)
vectors (train mode: mean = Σx·(1/n), msq = Σx²·(1/n), each rounded to
bf16 for the bf16 statistics; d = msq − mean², var = max(d, 0), inv =
rsqrt(var + eps), a = scale·inv, b = bias − mean·a; eval mode: the
running mean and variance for mean and var); the programs of row split
0 write the (C,) mean, var, inv and d that the backward and the running
averages read. Then one streaming pass over the 2-D grid writes
act(round(x·round(a) + round(b)) [+ r]), rounded to x's dtype at each
place the unfused chain rounds: x·a + b once (an FMA, as ATen's
``addcmul`` computes it; the product of two bf16 values is exact), y
before the residual add, the add in f32 and rounded once. The ReLU
passes NaN, as ``F.relu`` does. It is compiled without contracting any
other a·b + c into an FMA (``enable_fp_fusion`` off), so each f32
operation of the fold rounds as the separate ATen kernels round theirs;
1/n is rounded to f32 on the host, as ATen's division by a scalar does.
So in bf16 the output and the statistics equal the chain's on the card
bit for bit; the card tests hold it to within one ulp of y.

Not yet done (later work, with its times in PERF.md): TMA bulk loads,
persistent programs, the ReLU mask read inside K2 and the residual
gradient's add folded into ``bn_dx``.

``triton`` is imported, and the kernels are built, on the first launch
only: this module imports on a host with no Triton. The compiled kernels
are cached under ``<checkout>/.torch_kernels/triton`` (gitignored) unless
``TRITON_CACHE_DIR`` says otherwise.

``bn_stats(x2, round_sq=True)`` is the variant that the bf16 statistics of
the JAX package's ``GhostBatchNorm`` (``models/resnet.py:88-93``) need:
each x² is rounded to bf16 before it is summed, as ``xs * xs`` rounds in
a bf16 array, through a ``constexpr`` switch of the same kernel.

Each wrapper counts its launch (``utils/profiling.py``'s ``count``, as
"bn_stats", "bn_corr", "bn_dx", "bn_act") where it launches its kernel,
and nowhere else; a launch of the rounding variant also counts as
"bn_stats_rounded".
"""

import contextlib
import functools
import os

import numpy as np
import torch

from ..utils import profiling

os.environ.setdefault(
    "TRITON_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".torch_kernels", "triton"))

__all__ = ["bn_stats", "bn_corr", "bn_dx", "bn_act"]

#: elements of one (BLOCK_R, BLOCK_C) tile: 2 f32 accumulators of this size
#: over 4 warps keep the register use near 130 a thread
_TILE_ELEMS = 4096
_NUM_WARPS = 4
#: programs per SM the row splits aim for
_PROGRAMS_PER_SM = 4
#: bn_dx's tiles and programs per SM: it carries no accumulator
_DX_TILE_ELEMS = 8192
_DX_NUM_WARPS = 8
_DX_PROGRAMS_PER_SM = 16
#: bn_act's, from a sweep of 25 geometries at ResNet-50@448's shapes
#: (PERF.md): larger tiles and more programs than bn_dx's
_ACT_TILE_ELEMS = 16384
_ACT_NUM_WARPS = 4
_ACT_PROGRAMS_PER_SM = 64

_KERNELS = None
tl = None   # triton.language, bound on the first launch (see _kernels)


def _kernels():
    """Build (once) and return the four jitted kernels."""
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

    # R and R_pre change with the batch and the ghost prefix: not
    # specialised on, so one build serves every row count
    @triton.jit(do_not_specialize=["R", "R_pre"])
    def bn_dx_kernel(dy_ptr, x_ptr, dx_ptr, scale_ptr, mean_ptr, inv_ptr,
                     sdy_ptr, sdyx_ptr, sdy_own_ptr, sdyx_own_ptr, d_ptr,
                     dscale_ptr, R, C, R_pre, n,
                     BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
                     GHOST: tl.constexpr, ROUND_X: tl.constexpr):
        pid_c = tl.program_id(0)
        pid_s = tl.program_id(1)
        n_splits = tl.num_programs(1)
        cols = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        # prologue: this channel block's coefficients, as _dx_plain's
        mean = tl.load(mean_ptr + cols, mask=cmask, other=0.0)
        inv = tl.load(inv_ptr + cols, mask=cmask, other=0.0)
        sdy = tl.load(sdy_ptr + cols, mask=cmask, other=0.0)
        sdyx = tl.load(sdyx_ptr + cols, mask=cmask, other=0.0)
        g = tl.load(scale_ptr + cols, mask=cmask, other=0.0) \
            .to(tl.float32) * inv
        da = sdyx - mean * sdy
        if GHOST:   # d max(d, 0)/dd as jnp.maximum's: 1, ½ at 0, 0 below
            d = tl.load(d_ptr + cols, mask=cmask, other=0.0)
            da = da * tl.where(d > 0, 1.0, tl.where(d == 0, 0.5, 0.0))
        c0 = -(g * sdy) / n
        c1 = -(g * inv * inv * da) / n
        if pid_s == 0:
            sdy_o = tl.load(sdy_own_ptr + cols, mask=cmask, other=0.0)
            sdyx_o = tl.load(sdyx_own_ptr + cols, mask=cmask, other=0.0)
            tl.store(dscale_ptr + cols, (sdyx_o - mean * sdy_o) * inv,
                     mask=cmask)
        for r0 in range(pid_s * BLOCK_R, R, n_splits * BLOCK_R):
            rows = r0 + tl.arange(0, BLOCK_R)
            mask = (rows < R)[:, None] & cmask[None, :]
            pre = mask & (rows < R_pre)[:, None]
            offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
            dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            x = tl.load(x_ptr + offs, mask=pre, other=0.0)
            if ROUND_X:
                xf = x.to(tl.bfloat16).to(tl.float32)
            else:
                xf = x.to(tl.float32)
            t = c0[None, :] + (xf - mean[None, :]) * c1[None, :]
            dx = dy * g[None, :] + tl.where(pre, t, 0.0)
            tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty),
                     mask=mask)

    # R changes with the batch: not specialised on
    @triton.jit(do_not_specialize=["R"])
    def bn_act_kernel(x_ptr, r_ptr, out_ptr, scale_ptr, bias_ptr, u_ptr,
                      v_ptr, stats_ptr, R, C, inv_n, eps,
                      BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
                      TRAIN: tl.constexpr, ROUND_STATS: tl.constexpr,
                      RESIDUAL: tl.constexpr, RELU: tl.constexpr):
        pid_c = tl.program_id(0)
        pid_s = tl.program_id(1)
        n_splits = tl.num_programs(1)
        cols = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        # prologue: this channel block's a and b, as ops/bn.py::_fold's
        u = tl.load(u_ptr + cols, mask=cmask, other=0.0)
        v = tl.load(v_ptr + cols, mask=cmask, other=1.0)
        if TRAIN:   # u, v: Σx, Σx² over n rows
            mean = u * inv_n
            msq = v * inv_n
            if ROUND_STATS:   # jnp.mean of a bf16 array: a bf16 result
                mean = mean.to(tl.bfloat16).to(tl.float32)
                msq = msq.to(tl.bfloat16).to(tl.float32)
            d = msq - mean * mean
            var = tl.where(d < 0.0, 0.0, d)
        else:       # u, v: the running mean and variance
            mean = u
            var = v
        inv = tl.math.rsqrt(var + eps)
        a = tl.load(scale_ptr + cols, mask=cmask, other=0.0) \
            .to(tl.float32) * inv
        b = tl.load(bias_ptr + cols, mask=cmask, other=0.0) \
            .to(tl.float32) - mean * a
        if TRAIN:
            if pid_s == 0:
                tl.store(stats_ptr + cols, mean, mask=cmask)
                tl.store(stats_ptr + C + cols, var, mask=cmask)
                tl.store(stats_ptr + 2 * C + cols, inv, mask=cmask)
                tl.store(stats_ptr + 3 * C + cols, d, mask=cmask)
        ty = out_ptr.dtype.element_ty
        a = tl.broadcast_to(a.to(ty).to(tl.float32)[None, :],
                            (BLOCK_R, BLOCK_C))
        b = tl.broadcast_to(b.to(ty).to(tl.float32)[None, :],
                            (BLOCK_R, BLOCK_C))
        for r0 in range(pid_s * BLOCK_R, R, n_splits * BLOCK_R):
            rows = r0 + tl.arange(0, BLOCK_R)
            mask = (rows < R)[:, None] & cmask[None, :]
            offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            y = tl.fma(x, a, b)   # one rounding, as ATen's addcmul
            if RESIDUAL:   # y rounded first, the add in f32
                r = tl.load(r_ptr + offs, mask=mask, other=0.0)
                y = y.to(ty).to(tl.float32) + r.to(tl.float32)
            if RELU:       # NaN passes, as F.relu's
                y = tl.where(y <= 0.0, 0.0, y)
            tl.store(out_ptr + offs, y.to(ty), mask=mask)

    _KERNELS = (bn_stats_kernel, bn_corr_kernel, bn_dx_kernel,
                bn_act_kernel)
    return _KERNELS


def launch_shape(R: int, C: int, n_sms: int, tile_elems: int = _TILE_ELEMS,
                 programs_per_sm: int = _PROGRAMS_PER_SM):
    """(BLOCK_R, BLOCK_C, n_splits) for an (R, C) input on a card with
    `n_sms` SMs: channel blocks of up to 128 lanes, `tile_elems`-element
    tiles, and enough row splits for `programs_per_sm` programs per SM
    (never more splits than row blocks)."""
    block_c = min(128, max(16, 1 << (C - 1).bit_length()))
    block_r = tile_elems // block_c
    n_cblocks = -(-C // block_c)
    row_blocks = -(-R // block_r)
    want = -(-(programs_per_sm * n_sms) // n_cblocks)
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


def _check_vectors(name: str, C: int, params, f32s):
    """Contiguous CUDA (C,) vectors: `params` of any float dtype, `f32s`
    (sums and statistics) in f32."""
    for v in tuple(params) + tuple(f32s):
        if not (v.is_cuda and v.shape == (C,) and v.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous CUDA ({C},) "
                             f"vectors, got {v.device} {tuple(v.shape)}")
    for v in f32s:
        if v.dtype != torch.float32:
            raise ValueError(f"{name}: expected f32 per-channel sums and "
                             f"statistics, got {v.dtype}")


@functools.lru_cache(maxsize=256)
def _geometry(R: int, C: int, device_index: int, *tiling):
    n_sms = torch.cuda.get_device_properties(device_index) \
        .multi_processor_count
    block_r, block_c, n_splits = launch_shape(R, C, n_sms, *tiling)
    return block_r, block_c, n_splits, (-(-C // block_c), n_splits)


def _on_device(dev: torch.device):
    """Triton launches on the current device: switch only when it
    differs."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _launch(kernel, name: str, *ts: torch.Tensor, **constexprs):
    R, C = _check(name, *ts)
    dev = ts[0].device
    block_r, block_c, n_splits, grid = _geometry(R, C, dev.index)
    part = torch.empty((2, n_splits, C), device=dev, dtype=torch.float32)
    with _on_device(dev):
        kernel[grid](*ts, part, R, C, BLOCK_R=block_r, BLOCK_C=block_c,
                     num_warps=_NUM_WARPS, **constexprs)
    first, second = part.sum(dim=1)
    return first, second


def bn_stats(x2: torch.Tensor, round_sq: bool = False):
    """Σx and Σx² over the rows of a CUDA (R, C) matrix, in f32; with
    `round_sq` each x² is rounded to bf16 before the sum."""
    stats_kernel = _kernels()[0]
    out = _launch(stats_kernel, "bn_stats", x2, ROUND_SQ=bool(round_sq))
    profiling.count("bn_stats")
    if round_sq:
        profiling.count("bn_stats_rounded")
    return out


def bn_corr(dy2: torch.Tensor, x2: torch.Tensor):
    """Σdy and Σ(dy·x) over the rows of two CUDA (R, C) matrices, in f32."""
    corr_kernel = _kernels()[1]
    out = _launch(corr_kernel, "bn_corr", dy2, x2)
    profiling.count("bn_corr")
    return out


def bn_dx(dy2, x2, scale, mean, inv, sdy, sdyx, sdy_own, sdyx_own, n,
          r_pre, d=None, round_x=False, out=None):
    """dx of the train-mode BatchNorm over CUDA (R, C) matrices dy2, x2,
    and the scale's gradient: ``ops/bn.py::_dx_plain``'s arithmetic in
    one launch. The (C,) f32 vectors: the forward's mean and inv (and d,
    the variance before its clamp, on the ghost route), the sums over
    the statistics' rows (sdy, sdyx) and over this rank's (sdy_own,
    sdyx_own); n rows make the statistics, the first `r_pre` of these
    the ghost route's mean and variance terms reach (x rounded to bf16
    first with `round_x`). dx goes into `out` (a new tensor like x2 if
    None), in its dtype. Returns (dx2, dscale)."""
    out = torch.empty_like(x2) if out is None else out
    R, C = _check("bn_dx", dy2, x2, out)
    _check_vectors("bn_dx", C, (scale,), (mean, inv, sdy, sdyx, sdy_own,
                                         sdyx_own) + (
        () if d is None else (d,)))
    if not 0 <= r_pre <= R:
        raise ValueError(f"bn_dx: row limit {r_pre} outside [0, {R}]")
    dx_kernel = _kernels()[2]
    dev = x2.device
    block_r, block_c, _, grid = _geometry(
        R, C, dev.index, _DX_TILE_ELEMS, _DX_PROGRAMS_PER_SM)
    dscale = torch.empty(C, device=dev, dtype=torch.float32)
    with _on_device(dev):
        dx_kernel[grid](dy2, x2, out, scale, mean, inv, sdy, sdyx, sdy_own,
                        sdyx_own, mean if d is None else d, dscale, R, C,
                        int(r_pre), float(n), BLOCK_R=block_r,
                        BLOCK_C=block_c, GHOST=d is not None,
                        ROUND_X=bool(round_x), num_warps=_DX_NUM_WARPS)
    profiling.count("bn_dx")
    return out, dscale


def bn_act(x2, scale, bias, eps, u, v, n=None, round_stats=False,
           residual=None, relu=True, out=None):
    """act(x·a + b [+ residual]) of a CUDA (R, C) matrix x2 in one launch:
    ``ops/bn.py::_act_plain``'s arithmetic. With `n` (train mode) the
    (C,) f32 vectors u, v are Σx, Σx² over n rows (each mean rounded to
    bf16 with `round_stats`), else the running mean and variance; a =
    scale·rsqrt(var + eps), b = bias − mean·a. `residual`, an (R, C)
    matrix of x2's dtype, is added to y before the ReLU (with `relu`).
    The output goes into `out` (a new tensor like x2 if None), in x2's
    dtype. Returns (out, stats): stats the f32 (mean, var, inv, d) of
    train mode, d the variance before its clamp at 0; None in eval
    mode."""
    out = torch.empty_like(x2) if out is None else out
    R, C = _check("bn_act", x2, out, *(() if residual is None
                                        else (residual,)))
    for t in (out, residual):
        if t is not None and t.dtype != x2.dtype:
            raise ValueError(f"bn_act: expected the residual and output in "
                             f"x's dtype {x2.dtype}, got {t.dtype}")
    _check_vectors("bn_act", C, (scale, bias), (u, v))
    act_kernel = _kernels()[3]
    dev = x2.device
    block_r, block_c, _, grid = _geometry(
        R, C, dev.index, _ACT_TILE_ELEMS, _ACT_PROGRAMS_PER_SM)
    train = n is not None
    stats = torch.empty((4, C), device=dev, dtype=torch.float32) \
        if train else None
    # 1/n rounded to f32, as ATen divides by a scalar
    inv_n = float(np.float32(1.0) / np.float32(n)) if train else 1.0
    with _on_device(dev):
        act_kernel[grid](x2, x2 if residual is None else residual, out,
                         scale, bias, u, v, u if stats is None else stats,
                         R, C, inv_n, float(eps), BLOCK_R=block_r,
                         BLOCK_C=block_c, TRAIN=train,
                         ROUND_STATS=bool(round_stats),
                         RESIDUAL=residual is not None, RELU=bool(relu),
                         num_warps=_ACT_NUM_WARPS, enable_fp_fusion=False)
    profiling.count("bn_act")
    return out, None if stats is None else tuple(stats.unbind(0))
