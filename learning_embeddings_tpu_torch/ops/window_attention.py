"""Window attention for Swin (``models/swin.py``): softmax(q·kᵀ/√d +
bias)·v for every image, window and head, with q, k and v read from the
packed qkv projection and the output written in the layout the output
projection reads.

``window_attention(qkv, bias, heads)`` takes `qkv` (B, nW, N, 3C), the
``qkv`` Linear's output (C = heads·d; q, k, v the three thirds of the last
dim, head h at columns h·d .. h·d + d of each), and `bias` (1, nW·heads, N,
N) in qkv's dtype, the (window, head) pair w·heads + h at [0, w·heads + h],
broadcast over the images; it may take a gradient or not. It returns (B,
nW, N, C).

* On a CUDA tensor it launches the hand-written kernel pair of
  ``csrc/window_attention.cu`` (whose note gives its design) through
  ``_WindowAttention``, an autograd Function: the forward writes the
  output and one f32 log-sum-exp a row; the backward returns the qkv
  gradient as one packed (B, nW, N, 3C) tensor and the bias's gradient
  summed over the images in f32, rounded once to the bias's dtype
  (partials over chunks of images, added in order: deterministic). It
  takes bf16 alone, d in {16, 32, 64}, 1 ≤ N ≤ 144 and a contiguous bias
  of that shape, and raises otherwise: there is no fallback. Each kernel
  forward and each kernel backward counts as "window_attention".
* On the CPU it is the plain route: q, k and v unpacked as (B, nW·heads,
  N, d), ``ops/attention.py``'s softmax math with the same bias (scores and
  softmax in f32, the output rounded once), the output transposed back;
  autograd differentiates it.

Either way the call counts as "attention" and "attention_bias" (one for
the forward, one for its backward), and runs in the device spans
"attention.fwd" and "attention.bwd" (``profiling.traced_op``): the
backward span encloses the kernel backward and the partials' reduction.

Build: on the first CUDA call at a (N, d), ``pairwise_order.build_library``
compiles the source with ``-DWA_N=N -DWA_D=d`` into
``<checkout>/.torch_kernels/cuda/window_attention-<hash>.so`` (the hash is
of the source and the flags), loaded with ``ctypes``; nothing is compiled
or loaded when the module is imported or on the CPU path.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
from torch.autograd.function import once_differentiable

from ..utils import profiling
from . import pairwise_order
from .attention import _math

__all__ = ["window_attention", "window_attention_plain", "launch_plan",
           "HEAD_WIDTHS", "MAX_TOKENS"]

#: head widths the kernel is built for
HEAD_WIDTHS = (16, 32, 64)
#: the most tokens a window: the backward holds a (N, N) bias, P and dS of
#: one image in a block's shared memory
MAX_TOKENS = 144
#: a block's fixed work, its bias read and its bias-gradient partial
#: written, in images
BLOCK_COST = 2

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "window_attention.cu")

#: (N, d) → the loaded library
_LIBS: dict = {}
#: (library, device index, backward) → blocks an SM holds
_BLOCKS_PER_SM: dict = {}


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                           heads: int) -> torch.Tensor:
    """The plain route: qkv unpacked into (B, nW·heads, N, d) q, k, v,
    ``ops/attention.py``'s softmax math with `bias`, the output transposed
    back to (B, nW, N, C)."""
    B, nW, N, C3 = qkv.shape
    C = C3 // 3
    q, k, v = qkv.view(B, nW, N, 3, heads, C // heads).permute(
        3, 0, 1, 4, 2, 5).reshape(3, B, nW * heads, N, C // heads).unbind(0)
    y = _math(q, k, v, bias)
    return y.view(B, nW, heads, N, C // heads).transpose(2, 3).reshape(
        B, nW, N, C)


# --------------------------------------------------------------------------
# the launch plan (pure Python: a CPU test checks it)
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def launch_plan(batch: int, pairs: int, slots: int) -> tuple:
    """(images a block, chunks) for `batch` images of `pairs` (window,
    head) pairs on a card that runs `slots` blocks at once: the grid is
    pairs × chunks, and the chunk count is the one (the fewest of equals)
    whose waves of blocks, each ``BLOCK_COST`` + its images long, end
    first. Swin-L at B 64 on 132 one-block SMs: stage 1 (384 pairs) one
    chunk of 64, stage 2 (192) two of 32, stage 3 (96) four of 16, stage
    4 (48) five of 13."""
    if batch < 1 or pairs < 1 or slots < 1:
        raise ValueError(f"window_attention: no plan for {batch} images, "
                         f"{pairs} pairs on {slots} slots")
    best = None
    for n in range(1, batch + 1):
        chunk = -(-batch // n)
        n = -(-batch // chunk)
        cost = -(-pairs * n // slots) * (chunk + BLOCK_COST)
        if best is None or cost < best[0]:
            best = (cost, chunk, n)
    return best[1], best[2]


# --------------------------------------------------------------------------
# build and load
# --------------------------------------------------------------------------
def _library(N: int, d: int):
    """The kernels built for N tokens a window and head width d (built and
    loaded on first use)."""
    if (N, d) not in _LIBS:
        lib = ctypes.CDLL(pairwise_order.build_library(
            _SOURCE, "window_attention", (f"WA_N={N}", f"WA_D={d}")))
        # every pointer and the stream as c_void_p: ctypes would cut an
        # undeclared Python int to 32 bits
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wa_forward.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.wa_backward.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                    p]
        lib.wa_blocks_per_sm.argtypes = [i]
        for fn in (lib.wa_forward, lib.wa_backward, lib.wa_blocks_per_sm):
            fn.restype = ctypes.c_int
        _LIBS[(N, d)] = lib
    return _LIBS[(N, d)]


def _plan(device: torch.device, N: int, d: int, batch: int, pairs: int,
          backward: bool) -> tuple:
    lib = _library(N, d)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (lib._handle, index, backward)
    if key not in _BLOCKS_PER_SM:
        with torch.cuda.device(index):
            n = lib.wa_blocks_per_sm(int(backward))
        if n < 1:
            raise RuntimeError(f"window_attention: occupancy query failed "
                               f"(CUDA error {-n}, or no block fits)")
        _BLOCKS_PER_SM[key] = n
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return launch_plan(batch, pairs, _BLOCKS_PER_SM[key] * sms)


# --------------------------------------------------------------------------
# the kernel route
# --------------------------------------------------------------------------
def _check_card(qkv: torch.Tensor, bias: torch.Tensor, heads: int) -> None:
    """Raises ValueError where the kernels cannot take the inputs: another
    dtype than bf16, qkv not a contiguous (B, nW, N, 3·heads·d), d not in
    ``HEAD_WIDTHS``, N past ``MAX_TOKENS``, a bias not a contiguous (1,
    nW·heads, N, N) of qkv's dtype on qkv's device."""
    if qkv.dtype != torch.bfloat16 or bias.dtype != torch.bfloat16:
        raise ValueError(f"window_attention: the kernel takes bf16, got "
                         f"qkv {qkv.dtype} and bias {bias.dtype}")
    if qkv.ndim != 4 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"window_attention: qkv {tuple(qkv.shape)} is no "
                         f"(B, nW, N, 3·{heads}·d)")
    B, nW, N, C3 = qkv.shape
    d = C3 // (3 * heads)
    if d not in HEAD_WIDTHS:
        raise ValueError(f"window_attention: head width {d}; the kernel "
                         f"takes {HEAD_WIDTHS}")
    if not 1 <= N <= MAX_TOKENS:
        raise ValueError(f"window_attention: {N} tokens a window; the "
                         f"kernel takes 1 to {MAX_TOKENS}")
    if tuple(bias.shape) != (1, nW * heads, N, N):
        raise ValueError(f"window_attention: bias {tuple(bias.shape)}, "
                         f"expected {(1, nW * heads, N, N)}")
    if not qkv.is_contiguous() or not bias.is_contiguous():
        raise ValueError("window_attention: qkv and bias must be contiguous")
    if bias.device != qkv.device:
        raise ValueError(f"window_attention: qkv on {qkv.device}, bias on "
                         f"{bias.device}")
    if qkv.data_ptr() % 16 or bias.data_ptr() % 16:
        raise ValueError("window_attention: qkv and bias must start on 16 "
                         "bytes")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


class _WindowAttention(torch.autograd.Function):
    """The kernel pair: forward (out, log-sum-exp), backward (the packed qkv
    gradient, the bias's gradient summed over the images)."""

    @staticmethod
    def forward(ctx, qkv, bias, heads):
        B, nW, N, C3 = qkv.shape
        d = C3 // (3 * heads)
        lib = _library(N, d)
        grad = any(ctx.needs_input_grad[:2])
        out = torch.empty((B, nW, N, C3 // 3), dtype=qkv.dtype,
                          device=qkv.device)
        lse = torch.empty((B, nW * heads, N), dtype=torch.float32,
                          device=qkv.device) if grad else None
        chunk, chunks = _plan(qkv.device, N, d, B, nW * heads, False)
        with torch.cuda.device(qkv.device):
            err = lib.wa_forward(qkv.data_ptr(), bias.data_ptr(),
                                 out.data_ptr(),
                                 None if lse is None else lse.data_ptr(),
                                 B, nW, heads, chunk, chunks, _stream(qkv))
        if err != 0:
            raise RuntimeError(f"window_attention: forward launch failed "
                               f"with CUDA error {err}")
        profiling.count("window_attention")
        if grad:
            ctx.save_for_backward(qkv, bias, out, lse)
            ctx.heads = heads
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        qkv, bias, out, lse = ctx.saved_tensors
        heads = ctx.heads
        B, nW, N, C3 = qkv.shape
        d = C3 // (3 * heads)
        lib = _library(N, d)
        dout = dout.to(qkv.dtype).contiguous()
        dqkv = torch.empty_like(qkv)
        chunk, chunks = _plan(qkv.device, N, d, B, nW * heads, True)
        dbias = part = None
        if ctx.needs_input_grad[1]:
            dbias = torch.empty_like(bias)
            part = torch.empty((chunks, nW * heads, N, N),
                               dtype=torch.float32, device=qkv.device)
        with torch.cuda.device(qkv.device):
            err = lib.wa_backward(
                qkv.data_ptr(), bias.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), dqkv.data_ptr(),
                None if part is None else part.data_ptr(),
                None if dbias is None else dbias.data_ptr(),
                B, nW, heads, chunk, chunks, _stream(qkv))
        if err != 0:
            raise RuntimeError(f"window_attention: backward launch failed "
                               f"with CUDA error {err}")
        profiling.count("window_attention")
        return (dqkv if ctx.needs_input_grad[0] else None), dbias, None


def _kernel(qkv, bias, heads):
    _check_card(qkv, bias, heads)
    return _WindowAttention.apply(qkv, bias, heads)


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     heads: int) -> torch.Tensor:
    """softmax(q·kᵀ/√d + bias)·v of every window and head: `qkv` (B, nW,
    N, 3C) packed, `bias` (1, nW·heads, N, N) in qkv's dtype; (B, nW, N,
    C) out. CUDA tensors: the kernels; CPU tensors: the plain route."""
    if bias.dtype != qkv.dtype:
        raise ValueError(f"the attention bias is {bias.dtype}; the window "
                         f"attention takes it in qkv's dtype, {qkv.dtype}")
    return profiling.traced_op(
        "attention.fwd", "attention.bwd", ("attention", "attention_bias"),
        _kernel if qkv.device.type == "cuda" else window_attention_plain,
        qkv, bias, heads)
