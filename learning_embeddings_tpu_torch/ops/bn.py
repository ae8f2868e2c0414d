"""Train-mode BatchNorm: the port of ``learning_embeddings_tpu/ops/
bn_pallas.py`` and of the BatchNorm routes of the JAX package's
``models/resnet.py`` (``GhostBatchNorm``, flax's ``nn.BatchNorm``).

Three routes, chosen by ``make_norm`` with the JAX package's precedence
(``models/resnet.py:196-211``): ``bn_stats_rows`` or ``bn_stats_dtype``
first, then ``bn_impl``.

* ``FusedBatchNorm`` (``bn_impl='pallas'``): the two per-channel
  reductions go through ``_stats`` / ``_corr``: on a CUDA tensor they
  launch the Triton kernels of ``ops/bn_triton.py`` (always; there is no
  fallback on the card), on a CPU tensor they run the plain PyTorch
  versions below. The normalisation and the dx expression stay plain
  elementwise PyTorch.
* ``GhostBatchNorm`` (``bn_stats_rows`` > 0 or ``bn_stats_dtype`` bf16):
  the statistics come from the first ``stats_rows`` batch rows only (all
  rows for 0 or less), a contiguous row prefix of the (R, C) view that
  ``_stats`` reads with no copy; in bf16 each x² is rounded to bf16 before
  its sum and each mean is rounded to bf16 after it, as ``jnp.mean`` of a
  bf16 array does. Its gradient is the JAX package's autodiff written
  out: ``_corr`` over all R rows (every row's dy reaches the statistics
  through a and b), the mean and variance terms back into the prefix rows
  only, and none through ``max(var, 0)`` where it clamps.
* ``FlaxBatchNorm`` (``bn_impl='flax'``): the library's train-mode
  BatchNorm (``F.batch_norm``, whose kernels PyTorch picks: ATen's
  channels_last ones for the bf16 trunk on the card), as the JAX package's
  ``nn.BatchNorm`` is XLA's and no Pallas kernel. It launches no kernel of
  this repo. Its running statistics move with the biased variance (see
  ``_library_batch_norm_train``).

Same function as the JAX package computes:

* statistics from Σx and Σx² (not Welford; the flax route takes the
  library's two-pass variance instead): mean = Σx/R and the **biased**
  variance max(Σx²/R − mean², 0) — the running variance is updated with
  it on every route, unlike ``nn.BatchNorm2d``'s unbiased one;
* the forward folds into a = scale·rsqrt(var + eps), b = bias − mean·a in
  f32, then y = x·a + b in the activation dtype;
* the backward computes dx in f32 and casts it to x's dtype;
* flax momentum: running = 0.9·running + 0.1·batch; eps 1e-5.

Layout: channels sit at dim 1 (PyTorch's NCHW order), and the kernels read
each activation as a row-major (R = N·H·W, C) matrix, which is a free view
of a channels_last tensor. Any other layout costs an explicit copy, counted
in ``CHANNELS_LAST_COPIES``.

Rematerialisation: a block recomputed in the backward pass runs its
BatchNorm forward again; a module whose ``recomputing`` flag is set (the
trunks set it for the recompute, ``models/resnet.py``) leaves its running
statistics alone, so a step with remat updates them once, as flax's
functional remat does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["batch_norm_train", "ghost_batch_norm_train", "BatchNormBase",
           "FusedBatchNorm", "GhostBatchNorm", "FlaxBatchNorm", "make_norm",
           "BN_IMPLS", "BN_STATS_DTYPES", "CHANNELS_LAST_COPIES"]

#: the train-mode BatchNorm routes a trunk can take (``bn_impl``)
BN_IMPLS = ("pallas", "flax")
#: dtypes of the train-mode statistics (``bn_stats_dtype``)
BN_STATS_DTYPES = ("float32", "bfloat16")

#: channels_last copies made to view an input as an (R, C) matrix
CHANNELS_LAST_COPIES = 0


def _stats_plain(x2, round_sq=False):
    xf = x2.float()
    sq = xf * xf
    if round_sq:
        sq = sq.to(torch.bfloat16).float()
    return xf.sum(0), sq.sum(0)


def _corr_plain(dy2, x2):
    dyf = dy2.float()
    return dyf.sum(0), (dyf * x2.float()).sum(0)


def _stats(x2, round_sq=False):
    """Σx, Σx² over the rows of x2 (R, C): kernel on the card, plain on
    the CPU; with `round_sq` each x² is rounded to bf16 before the sum."""
    if x2.is_cuda:
        from . import bn_triton
        return bn_triton.bn_stats(x2, round_sq)
    if x2.device.type == "cpu":
        return _stats_plain(x2, round_sq)
    raise ValueError(f"no BatchNorm statistics path for {x2.device}")


def _corr(dy2, x2):
    """Σdy, Σ(dy·x) over the rows: kernel on the card, plain on CPU."""
    if x2.is_cuda:
        from . import bn_triton
        return bn_triton.bn_corr(dy2, x2)
    if x2.device.type == "cpu":
        return _corr_plain(dy2, x2)
    raise ValueError(f"no BatchNorm backward path for {x2.device}")


def _channel_minor(t):
    """`t` with its channels (dim 1) innermost in memory; copies (and
    counts the copy) when they are not."""
    global CHANNELS_LAST_COPIES
    if t.movedim(1, -1).is_contiguous():
        return t
    CHANNELS_LAST_COPIES += 1
    return t.movedim(1, -1).contiguous().movedim(-1, 1)


def _rows(t):
    """(R, C) view of a channel-minor tensor."""
    return t.movedim(1, -1).view(-1, t.shape[1])


def _per_channel(v, like):
    """(C,) vector broadcastable against `like` along dim 1."""
    return v.view((1, -1) + (1,) * (like.ndim - 2))


class _BatchNormTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x = _channel_minor(x)
        x2 = _rows(x)
        R = x2.shape[0]
        s, q = _stats(x2)
        mean = s / R
        var = torch.clamp_min(q / R - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        a = scale.float() * inv
        b = bias.float() - mean * a
        y = torch.addcmul(_per_channel(b.to(x.dtype), x), x,
                          _per_channel(a.to(x.dtype), x))
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        # the statistics are consumed without gradient (running averages)
        x, scale, mean, inv = ctx.saved_tensors
        dy = _channel_minor(dy)
        R = x.numel() // x.shape[1]
        sdy, sdyx = _corr(_rows(dy), _rows(x))
        # Σ dy·x̂ = (Σ dy·x − mean·Σ dy) · inv
        sdyxh = (sdyx - mean * sdy) * inv
        g = scale.float() * inv
        mean_dy = sdy / R
        mean_dyxh = sdyxh / R
        xhat = (x.float() - _per_channel(mean, x)).mul_(_per_channel(inv, x))
        dx = (dy.to(torch.float32, copy=True)
              .sub_(_per_channel(mean_dy, x))
              .sub_(xhat.mul_(_per_channel(mean_dyxh, x)))
              .mul_(_per_channel(g, x)))
        return (dx.to(x.dtype), sdyxh.to(scale.dtype), sdy.to(scale.dtype),
                None)


def batch_norm_train(x, scale, bias, eps: float = 1e-5):
    """Train-mode batch norm of x (N, C, ...) over all axes but dim 1.

    Returns (y, mean, var): biased variance, f32 statistics, y in x.dtype
    and in x's channel-minor layout. mean and var carry no gradient."""
    return _BatchNormTrain.apply(x, scale, bias, eps)


class _GhostBatchNormTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps, stats_rows, round_bf16):
        x = _channel_minor(x)
        n_img = x.shape[0]
        rows = min(stats_rows, n_img) if stats_rows > 0 else n_img
        x2 = _rows(x)
        xs2 = x2[:rows * (x2.shape[0] // n_img)]    # the rows' prefix view
        if round_bf16:
            xs2 = xs2.to(torch.bfloat16)
        n = xs2.shape[0]
        s, q = _stats(xs2, True) if round_bf16 else _stats(xs2)
        mean, msq = s / n, q / n
        if round_bf16:   # jnp.mean of a bf16 array: f32 sum, bf16 result
            mean = mean.to(torch.bfloat16).float()
            msq = msq.to(torch.bfloat16).float()
        d = msq - mean * mean
        var = torch.clamp_min(d, 0.0)
        inv = torch.rsqrt(var + eps)
        a = scale.float() * inv
        b = bias.float() - mean * a
        y = torch.addcmul(_per_channel(b.to(x.dtype), x), x,
                          _per_channel(a.to(x.dtype), x))
        ctx.save_for_backward(x, scale, mean, inv, d)
        ctx.rows, ctx.n, ctx.round_bf16 = rows, n, round_bf16
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, inv, d = ctx.saved_tensors
        dy = _channel_minor(dy)
        sdy, sdyx = _corr(_rows(dy), _rows(x))    # over all R rows
        g = scale.float() * inv
        # through b = bias − mean·a: da = Σdy·x − mean·Σdy
        da = sdyx - mean * sdy
        # d max(d, 0)/dd as jnp.maximum's: 1 above 0, ½ at 0, 0 below
        slope = (d > 0).float() + 0.5 * (d == 0).float()
        dvar = -0.5 * inv ** 3 * scale.float() * da * slope
        dmean = -sdy * g - 2 * mean * dvar
        dx = dy.to(torch.float32, copy=True).mul_(_per_channel(g, x))
        xs = x[:ctx.rows]
        if ctx.round_bf16:
            xs = xs.to(torch.bfloat16)
        dx[:ctx.rows].add_(_per_channel(dmean / ctx.n, x)).add_(
            torch.mul(xs.float(), _per_channel(2 * dvar / ctx.n, x)))
        return (dx.to(x.dtype), (da * inv).to(scale.dtype),
                sdy.to(scale.dtype), None, None, None)


def ghost_batch_norm_train(x, scale, bias, eps: float = 1e-5,
                           stats_rows: int = 8,
                           stats_dtype: torch.dtype = torch.float32):
    """``batch_norm_train`` with the statistics of the first `stats_rows`
    batch rows (all for ≤ 0) in `stats_dtype` (float32 or bfloat16): the
    JAX package's ``GhostBatchNorm`` in train mode. The normalisation
    covers every row. Returns (y, mean, var)."""
    if stats_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stats_dtype must be float32 or bfloat16, got "
                         f"{stats_dtype}")
    return _GhostBatchNormTrain.apply(x, scale, bias, eps, int(stats_rows),
                                      stats_dtype == torch.bfloat16)


def _library_batch_norm_train(x, scale, bias, eps: float):
    """The library's train-mode BatchNorm of x (N, C, ...): (y, mean, var)
    with the biased variance. ``F.batch_norm`` writes the batch mean and
    the *unbiased* variance Σ(x − mean)²/(R − 1) into running buffers;
    buffers that start at 0 with momentum 1 hold exactly those, and
    (R − 1)/R turns the variance into the biased one the JAX package's
    running statistics take."""
    C = x.shape[1]
    mean = torch.zeros(C, device=x.device)
    var = torch.zeros(C, device=x.device)
    y = F.batch_norm(x, mean, var, scale, bias, training=True, momentum=1.0,
                     eps=eps)
    R = x.numel() // C
    # out of place: autograd keeps `var` for the library's backward
    return y, mean, var * ((R - 1) / R)


class BatchNormBase(nn.Module):
    """Parameters, running statistics and eval mode shared by the train-
    mode routes. Parameters and buffers use torchvision's names (weight,
    bias, running_mean, running_var); eval mode folds the running
    statistics into a = weight·rsqrt(var + eps), b = bias − mean·a.

    `dtype` is the activation dtype the input is cast to; parameters and
    running statistics stay f32. Subclasses give ``_train(x)`` → (y,
    mean, var)."""

    #: flax's momentum (the running value keeps 0.9 of itself) and eps
    momentum = 0.9
    eps = 1e-5

    def __init__(self, num_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        #: set while a rematerialised block recomputes its forward: the
        #: running statistics were updated by the first forward already
        self.recomputing = False
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _train(self, x):
        raise NotImplementedError

    def forward(self, x):
        x = x.to(self.dtype)
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps)
            a = self.weight * inv
            b = self.bias - self.running_mean * a
            return torch.addcmul(_per_channel(b.to(self.dtype), x), x,
                                 _per_channel(a.to(self.dtype), x))
        y, mean, var = self._train(x)
        if not self.recomputing:
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean
                                        + (1 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var
                                       + (1 - self.momentum) * var)
        return y


class FusedBatchNorm(BatchNormBase):
    """``nn.Module`` twin of the JAX package's ``PallasBatchNorm``: train
    mode runs ``batch_norm_train`` (the kernels on the card)."""

    def _train(self, x):
        return batch_norm_train(x, self.weight, self.bias, self.eps)


class GhostBatchNorm(BatchNormBase):
    """Twin of the JAX package's ``GhostBatchNorm``: train-mode statistics
    of the first `stats_rows` batch rows (all for ≤ 0) in `stats_dtype`
    (float32, or bfloat16: K1's rounding variant on the card)."""

    def __init__(self, num_features: int,
                 dtype: torch.dtype = torch.bfloat16, stats_rows: int = 8,
                 stats_dtype: torch.dtype = torch.float32):
        super().__init__(num_features, dtype)
        self.stats_rows = int(stats_rows)
        self.stats_dtype = stats_dtype

    def _train(self, x):
        return ghost_batch_norm_train(x, self.weight, self.bias, self.eps,
                                      self.stats_rows, self.stats_dtype)


class FlaxBatchNorm(BatchNormBase):
    """Counterpart of flax's ``nn.BatchNorm`` (``bn_impl='flax'``): the
    library's train-mode BatchNorm, no kernel of this repo; the running
    statistics move with the biased variance and flax's momentum."""

    def _train(self, x):
        return _library_batch_norm_train(x, self.weight, self.bias, self.eps)


def make_norm(bn_impl: str = "pallas", bn_stats_rows: int = 0,
              bn_stats_dtype: str = "float32",
              dtype: torch.dtype = torch.bfloat16):
    """A constructor C → BatchNorm module with the JAX package's precedence
    (``models/resnet.py:196-211``): a ghost row count or bf16 statistics
    select ``GhostBatchNorm`` (all rows when `bn_stats_rows` is 0), else
    `bn_impl` picks ``FusedBatchNorm`` ('pallas') or ``FlaxBatchNorm``
    ('flax')."""
    if bn_impl not in BN_IMPLS:
        raise ValueError(f"unknown bn_impl {bn_impl!r}; expected one of "
                         f"{BN_IMPLS}")
    if bn_stats_dtype not in BN_STATS_DTYPES:
        raise ValueError(f"unknown bn_stats_dtype {bn_stats_dtype!r}; "
                         f"expected one of {BN_STATS_DTYPES}")
    if bn_stats_rows or bn_stats_dtype != "float32":
        stats_dtype = getattr(torch, bn_stats_dtype)
        return lambda c: GhostBatchNorm(c, dtype, bn_stats_rows or -1,
                                        stats_dtype)
    if bn_impl == "pallas":
        return lambda c: FusedBatchNorm(c, dtype)
    return lambda c: FlaxBatchNorm(c, dtype)
