"""Train-mode BatchNorm: the port of ``learning_embeddings_tpu/ops/
bn_pallas.py`` and of the BatchNorm routes of the JAX package's
``models/resnet.py`` (``GhostBatchNorm``, flax's ``nn.BatchNorm``).

Three routes, chosen by ``make_norm`` with the JAX package's precedence
(``models/resnet.py:196-211``): ``bn_stats_rows`` or ``bn_stats_dtype``
first, then ``bn_impl``.

* ``FusedBatchNorm`` (``bn_impl='pallas'``): the two per-channel
  reductions go through ``_stats`` / ``_corr``, the forward's fold and
  normalisation, with the ReLU and residual add that follow it, through
  ``_act``, and the backward's dx and scale gradient through ``_dx``: on
  a CUDA tensor they launch the Triton kernels of ``ops/bn_triton.py``
  (always; there is no fallback on the card), on a CPU tensor they run
  the plain PyTorch versions below.
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
  ``nn.BatchNorm`` is XLA's and no Pallas kernel, followed by the plain
  residual add and ReLU. It launches no kernel of this repo in train
  mode. Its running statistics move with the biased variance (see
  ``_library_batch_norm_train``).

The fused and the ghost route are one autograd Function
(``_BatchNormTrain``): the fused route is the ghost route over all rows
in f32, save the backward's slope of ``max(var, 0)``: 1 everywhere on
the fused route, as the JAX ``batch_norm_train``'s custom VJP (no
clamp), and ``jnp.maximum``'s on the ghost route (½ at the clamp, 0
below), as JAX's autodiff of ``GhostBatchNorm``.

The activation: a module's ``act(x, residual, relu)`` is relu(bn(x) +
residual) (the add with a residual, the ReLU with `relu`), which the
trunks call in place of ``F.relu(bn(x) [+ residual])``; ``forward(x)`` is
``act(x, relu=False)``. The train routes of the port (fused, ghost) take
both into their autograd Function: the forward runs ``_act`` once (the
``bn_act`` kernel on the card) and keeps its output for the ReLU's mask,
and the backward masks dy as autograd's ReLU does (``threshold_backward``
on that output), returns the masked dy as the residual's gradient, then
runs K2 and ``_dx``. Eval mode launches ``_act`` with the running
statistics, except where autograd records (a gradient through an eval
BatchNorm), which runs the plain chain ``_act_plain``.

Same function as the JAX package computes:

* statistics from Σx and Σx² (not Welford; the flax route takes the
  library's two-pass variance instead): mean = Σx/R and the **biased**
  variance max(Σx²/R − mean², 0) — the running variance is updated with
  it on every route, unlike ``nn.BatchNorm2d``'s unbiased one;
* the forward folds into a = scale·rsqrt(var + eps), b = bias − mean·a in
  f32, then y = x·a + b in the activation dtype (a and b rounded to it
  first); the residual add in f32, y rounded to the activation dtype
  before it and the sum after it;
* the backward computes dx in f32 and rounds it once to x's dtype;
* flax momentum: running = 0.9·running + 0.1·batch; eps 1e-5.

Layout: channels sit at dim 1 (PyTorch's NCHW order), and the kernels read
each activation as a row-major (R = N·H·W, C) matrix, which is a free view
of a channels_last tensor. Any other layout costs an explicit copy, counted
as "channels_last_copies" (``utils/profiling.py``'s ``count``).

On a mesh (``group``: a process group of ``parallel/mesh.py``; None is
one device) the statistics are those of the global batch, as GSPMD's
all-reduce makes them in the JAX package: each rank runs K1 / K2 on its
own rows, the f32 (2, C) sums are all-reduced over the group (one
``all_reduce`` per BN layer and pass, counted as "collective_bn_stats" /
"collective_bn_corr"), and the epilogue runs on the global
sums, so the running statistics are equal on every rank. The gradient of
the scale and bias is this rank's share (the trainer's gradient
all-reduce adds the shares); dx takes the global sums. Each layer has its
own group (``set_batch_norm_group``): the 'data' group where each rank
holds whole images, every rank (``Mesh.world_group``) for a layer whose
images are also split along H over 'model' (spatial partitioning,
``parallel/spatial.py``), where `parts` ranks — the model group — hold
the pieces of the same images. Ghost statistics cover the first images
of the *global* batch: a rank whose images lie past the prefix adds
zeros and launches no K1; its images are found by its data index, which
is its rank in the group divided by `parts`. bf16 statistics round the
all-reduced means. The flax route takes the library's synchronised
statistics (``torch.batch_norm_stats``,
``torch.batch_norm_gather_stats_with_counts``, the kernels
``nn.SyncBatchNorm`` runs) on the card, and their plain equivalent on the
CPU, where those operators do not exist. Every shard has the same number
of rows.

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

from ..parallel.mesh import (all_gather_rows, all_reduce_, group_rank,
                             group_size)
from ..utils import profiling

__all__ = ["batch_norm_train", "ghost_batch_norm_train", "BatchNormBase",
           "FusedBatchNorm", "GhostBatchNorm", "FlaxBatchNorm", "make_norm",
           "set_batch_norm_group", "BN_IMPLS", "BN_STATS_DTYPES"]

#: the train-mode BatchNorm routes a trunk can take (``bn_impl``)
BN_IMPLS = ("pallas", "flax")
#: dtypes of the train-mode statistics (``bn_stats_dtype``)
BN_STATS_DTYPES = ("float32", "bfloat16")


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


def _summed(group, tag, *sums):
    """Per-channel f32 sums added over `group` (one all_reduce of the
    stacked (k, C) buffer); unchanged for one device."""
    if group is None:
        return sums
    return all_reduce_(torch.stack(sums), group, tag).unbind(0)


def _channel_minor(t):
    """`t` with its channels (dim 1) innermost in memory; copies (and
    counts the copy as "channels_last_copies") when they are not."""
    if t.movedim(1, -1).is_contiguous():
        return t
    profiling.count("channels_last_copies")
    return t.movedim(1, -1).contiguous().movedim(-1, 1)


def _rows(t):
    """(R, C) view of a channel-minor tensor."""
    return t.movedim(1, -1).view(-1, t.shape[1])


def _per_channel(v, like):
    """(C,) vector broadcastable against `like` along dim 1."""
    return v.view((1, -1) + (1,) * (like.ndim - 2))


def _dx_plain(dy2, x2, scale, mean, inv, sdy, sdyx, sdy_own, sdyx_own, n,
              r_pre, d=None, round_x=False, out=None):
    """``bn_triton.bn_dx`` in plain PyTorch, term by term: the CPU's path
    and the kernel's oracle. With g = scale·inv,
    c0 = −g·Σdy/n and c1 = −g·inv²·(Σdy·x − mean·Σdy)·slope/n,

        dx = dy·g + [row < r_pre]·(c0 + (x_r − mean)·c1)

    in f32, rounded once to `out`'s dtype (x2's by default). The plain
    route is r_pre = n = R and slope 1: g·(dy − mean_dy − x̂·mean_dyxh)
    regrouped, the mean subtracted before any scaling. The ghost route
    (`d` given): n prefix rows, r_pre of them on this rank, the slope of
    max(d, 0) and x_r = x rounded to bf16 with `round_x`; these are the
    JAX package's dvar and dmean terms, dmean/n + x_r·2dvar/n. Returns
    (dx2, dscale), dscale = (Σdy·x − mean·Σdy)·inv over this rank's own
    sums."""
    g = scale.float() * inv
    da = sdyx - mean * sdy
    if d is not None:   # d max(d, 0)/dd as jnp.maximum's: 1, ½ at 0, 0 below
        da = da * ((d > 0).float() + 0.5 * (d == 0).float())
    c0 = -(g * sdy) / n
    c1 = -(g * inv * inv * da) / n
    dx = dy2.float() * g
    xs = x2[:r_pre]
    if round_x:
        xs = xs.to(torch.bfloat16)
    dx[:r_pre] += c0 + (xs.float() - mean) * c1
    out = torch.empty_like(x2) if out is None else out
    out.copy_(dx)
    return out, (sdyx_own - mean * sdy_own) * inv


def _dx(dy, x, scale, mean, inv, sdy, sdyx, sdy_own, sdyx_own, n, r_pre,
        d=None, round_x=False):
    """The backward after K2's sums (the statistics' rows: sdy, sdyx;
    this rank's: sdy_own, sdyx_own): dx in x's dtype and layout, and the
    scale's and bias's gradients from this rank's rows. The kernel on
    the card, ``_dx_plain`` on the CPU (arguments as theirs). Run in the
    span "bn.bwd_epilogue"."""
    dx = torch.empty_like(x)
    args = (_rows(dy), _rows(x), scale, mean, inv, sdy, sdyx, sdy_own,
            sdyx_own, n, r_pre, d, round_x)
    if x.is_cuda:
        from . import bn_triton
        _, dscale = bn_triton.bn_dx(*args, out=_rows(dx))
    elif x.device.type == "cpu":
        _, dscale = _dx_plain(*args, out=_rows(dx))
    else:
        raise ValueError(f"no BatchNorm dx path for {x.device}")
    return dx, dscale.to(scale.dtype), sdy_own.to(scale.dtype)


def _fold(scale, bias, eps, u, v, n=None, round_bf16=False):
    """The per-channel coefficients in f32. With `n` (train mode) from
    K1's sums u = Σx, v = Σx² over n rows: the means (each rounded to
    bf16 with `round_bf16`), d = msq − mean² and the biased variance
    max(d, 0); else (eval mode) u, v are the running mean and variance.
    Then inv = rsqrt(var + eps), a = scale·inv, b = bias − mean·a.
    Returns (a, b, (mean, var, inv, d)), d None in eval mode."""
    if n is None:
        mean, var, d = u, v, None
    else:
        mean, msq = u / n, v / n
        if round_bf16:   # jnp.mean of a bf16 array: f32 sum, bf16 result
            mean = mean.to(torch.bfloat16).float()
            msq = msq.to(torch.bfloat16).float()
        d = msq - mean * mean
        var = torch.clamp_min(d, 0.0)
    inv = torch.rsqrt(var + eps)
    a = scale.float() * inv
    b = bias.float() - mean * a
    return a, b, (mean, var, inv, d)


def _act_plain(x, scale, bias, eps, u, v, n=None, round_bf16=False,
               residual=None, relu=True):
    """``bn_triton.bn_act`` in plain PyTorch, the unfused chain: the fold
    (``_fold``, arguments as its), y = x·a + b in x's dtype
    (``addcmul``), y + residual, ReLU. x is (N, C, ...) with channels at
    dim 1, or an (R, C) matrix. The CPU's route, the kernel's oracle, and
    eval mode's route where autograd records. Returns (out, stats): the
    f32 (mean, var, inv, d) of train mode, None in eval mode."""
    a, b, stats = _fold(scale, bias, eps, u, v, n, round_bf16)
    y = torch.addcmul(_per_channel(b.to(x.dtype), x), x,
                      _per_channel(a.to(x.dtype), x))
    if residual is not None:
        y = y + residual
    if relu:
        y = F.relu(y)
    return y, None if n is None else stats


def _act(x, scale, bias, eps, u, v, n=None, round_bf16=False,
         residual=None, relu=True):
    """act(x·a + b [+ residual]) in x's dtype: the kernel on the card (in
    x's channel-minor layout), ``_act_plain`` on the CPU (arguments and
    result as its). Train mode runs it in the span "bn.fwd_epilogue"."""
    if x.is_cuda:
        from . import bn_triton
        x = _channel_minor(x)
        out = torch.empty_like(x)
        r2 = None if residual is None else _rows(_channel_minor(residual))
        _, stats = bn_triton.bn_act(_rows(x), scale, bias, eps, u, v, n,
                                    round_bf16, r2, relu, out=_rows(out))
        return out, stats
    if x.device.type == "cpu":
        return _act_plain(x, scale, bias, eps, u, v, n, round_bf16,
                          residual, relu)
    raise ValueError(f"no BatchNorm forward path for {x.device}")


def _relu_mask(dy, out):
    """dy through the ReLU whose output is `out` (None: no ReLU), as
    autograd's ReLU backward computes it."""
    return dy if out is None else torch.ops.aten.threshold_backward(
        dy, out, 0)


class _BatchNormTrain(torch.autograd.Function):
    """The fused and ghost routes' train-mode BatchNorm: `stats_rows`,
    `round_bf16` and `clamp_slope` are the route's statistics spec, which
    ``batch_norm_train`` and ``ghost_batch_norm_train`` fix."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, relu, eps, group, parts,
                stats_rows, round_bf16, clamp_slope):
        x = _channel_minor(x)
        n_img = x.shape[0]
        # the prefix of the global batch; this rank holds (its `parts`-th
        # piece of) images [k·n_img, (k + 1)·n_img) of it, k its data index
        total = n_img * (group_size(group) // parts)
        prefix = min(stats_rows, total) if stats_rows > 0 else total
        k = group_rank(group) // parts
        rows = min(max(prefix - k * n_img, 0), n_img)
        x2 = _rows(x)
        per_img = x2.shape[0] // n_img
        xs2 = x2[:rows * per_img]                   # the rows' prefix view
        if round_bf16:
            xs2 = xs2.to(torch.bfloat16)
        n = prefix * per_img * parts
        if rows:
            s, q = _stats(xs2, True) if round_bf16 else _stats(xs2)
        else:   # no row of this rank is in the prefix: no launch
            s = q = torch.zeros(x2.shape[1], device=x.device)
        s, q = _summed(group, "bn_stats", s, q)
        y, (mean, var, inv, d) = profiling.in_device_span(
            "bn.fwd_epilogue", x.device, _act, x, scale, bias, eps, s, q, n,
            round_bf16, residual, relu)
        ctx.save_for_backward(x, scale, mean, inv,
                              d if clamp_slope else None, y if relu else None)
        ctx.r_pre, ctx.n, ctx.round_bf16 = xs2.shape[0], n, round_bf16
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        # the statistics are consumed without gradient (running averages)
        x, scale, mean, inv, d, out = ctx.saved_tensors
        dy = _relu_mask(_channel_minor(dy), out)
        sdy_own, sdyx_own = _corr(_rows(dy), _rows(x))    # over all R rows
        sdy, sdyx = _summed(ctx.group, "bn_corr", sdy_own, sdyx_own)
        dx, dscale, dbias = profiling.in_device_span(
            "bn.bwd_epilogue", x.device, _dx, dy, x, scale, mean, inv, sdy,
            sdyx, sdy_own, sdyx_own, ctx.n, ctx.r_pre, d, ctx.round_bf16)
        return (dx, dscale, dbias, dy if ctx.needs_input_grad[3] else None,
                ) + (None,) * 7


def batch_norm_train(x, scale, bias, eps: float = 1e-5, group=None,
                     residual=None, relu: bool = False):
    """Train-mode batch norm of x (N, C, ...) over all axes but dim 1, and
    over the ranks of `group` (None: this device's rows only), then
    `residual` (x's shape and dtype) added and a ReLU with `relu`.

    Returns (y, mean, var): biased variance, f32 statistics, y in x.dtype
    and in x's channel-minor layout. mean and var carry no gradient."""
    return _BatchNormTrain.apply(x, scale, bias, residual, bool(relu), eps,
                                 group, 1, 0, False, False)


def ghost_batch_norm_train(x, scale, bias, eps: float = 1e-5,
                           stats_rows: int = 8,
                           stats_dtype: torch.dtype = torch.float32,
                           group=None, parts: int = 1, residual=None,
                           relu: bool = False):
    """``batch_norm_train`` with the statistics of the first `stats_rows`
    batch rows (all for ≤ 0) of the global batch (over the ranks of
    `group`, `parts` of which hold pieces of the same images) in
    `stats_dtype` (float32 or bfloat16): the JAX package's
    ``GhostBatchNorm`` in train mode. The normalisation covers every row;
    `residual` and `relu` as ``batch_norm_train``'s. Returns (y, mean,
    var)."""
    if stats_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stats_dtype must be float32 or bfloat16, got "
                         f"{stats_dtype}")
    return _BatchNormTrain.apply(x, scale, bias, residual, bool(relu), eps,
                                 group, int(parts), int(stats_rows),
                                 stats_dtype == torch.bfloat16, True)


def _own_stats(x, eps: float):
    """(mean, invstd) of x's rows in f32, biased variance: the library's
    ``torch.batch_norm_stats`` on the card, its plain equivalent on the
    CPU (where the operator does not exist)."""
    if x.is_cuda:
        return torch.batch_norm_stats(x, eps)
    dims = [0] + list(range(2, x.ndim))
    xf = x.float()
    return xf.mean(dims), torch.rsqrt(xf.var(dims, correction=0) + eps)


class _SyncBatchNormTrain(torch.autograd.Function):
    """The library's synchronised train-mode BatchNorm over `group` (what
    ``nn.SyncBatchNorm`` runs), with the plain equivalent on the CPU."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, group):
        x = _channel_minor(x)
        C = x.shape[1]
        mean, invstd = _own_stats(x, eps)
        own = torch.cat([mean, invstd,
                         mean.new_full((1,), x.numel() // C)])[None]
        every = all_gather_rows(own, group, "bn_stats")      # (p, 2C + 1)
        means, invstds, counts = every[:, :C], every[:, C:2 * C], every[:, -1]
        N = float(counts.sum())
        if x.is_cuda:
            # momentum 1 into zeroed buffers: the unbiased global variance
            run_mean = torch.zeros(C, device=x.device)
            run_var = torch.zeros(C, device=x.device)
            mean, invstd = torch.batch_norm_gather_stats_with_counts(
                x, means, invstds, run_mean, run_var, 1.0, eps, counts)
            var = run_var * ((N - 1) / N)
            y = torch.batch_norm_elemt(x, scale, bias, mean, invstd, eps)
        else:
            w = (counts / N)[:, None]
            mean = (w * means).sum(0)
            var = (w * (invstds.pow(-2) - eps + (means - mean) ** 2)).sum(0)
            invstd = torch.rsqrt(var + eps)
            y = ((x.float() - _per_channel(mean, x))
                 * _per_channel(invstd * scale.float(), x)
                 + _per_channel(bias.float(), x)).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, invstd, counts)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, invstd, counts = ctx.saved_tensors
        dy = _channel_minor(dy)
        if x.is_cuda:
            sdy_own, sdyxmu_own, dscale, dbias = \
                torch.batch_norm_backward_reduce(dy, x, mean, invstd, scale,
                                                 True, True, True)
        else:
            dims = [0] + list(range(2, x.ndim))
            dyf = dy.float()
            xmu = x.float() - _per_channel(mean, x)
            sdy_own, sdyxmu_own = dyf.sum(dims), (dyf * xmu).sum(dims)
            dscale, dbias = sdyxmu_own * invstd, sdy_own
        sdy, sdyxmu = _summed(ctx.group, "bn_corr", sdy_own, sdyxmu_own)
        if x.is_cuda:
            dx = torch.batch_norm_backward_elemt(
                dy, x, mean, invstd, scale, sdy, sdyxmu,
                counts.to(torch.int32))
        else:
            N = counts.sum()
            dx = ((dyf - _per_channel(sdy / N, x)
                   - xmu * _per_channel(invstd * invstd * sdyxmu / N, x))
                  * _per_channel(invstd * scale.float(), x)).to(x.dtype)
        return (dx, dscale.to(scale.dtype), dbias.to(scale.dtype), None,
                None)


def _library_batch_norm_train(x, scale, bias, eps: float, group=None):
    """The library's train-mode BatchNorm of x (N, C, ...): (y, mean, var)
    with the biased variance. ``F.batch_norm`` writes the batch mean and
    the *unbiased* variance Σ(x − mean)²/(R − 1) into running buffers;
    buffers that start at 0 with momentum 1 hold exactly those, and
    (R − 1)/R turns the variance into the biased one the JAX package's
    running statistics take. Over a `group` of ranks: the library's
    synchronised statistics (``_SyncBatchNormTrain``)."""
    if group is not None:
        return _SyncBatchNormTrain.apply(x, scale, bias, eps, group)
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
    running statistics stay f32. Subclasses give ``_train(x, residual,
    relu)`` → (act(y [+ residual]), mean, var)."""

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
        #: the ranks the statistics reduce over, and how many of them
        #: hold pieces of the same images (``set_batch_norm_group``)
        self.group = None
        self.parts = 1
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _train(self, x, residual, relu):
        raise NotImplementedError

    def act(self, x, residual=None, relu: bool = True):
        """relu(bn(x) + residual): the residual (x's shape, in the
        activation dtype) added when given, the ReLU with `relu`; in the
        activation dtype."""
        x = x.to(self.dtype)
        if self.training:
            y, mean, var = self._train(x, residual, relu)
            if not self.recomputing:
                with torch.no_grad():
                    self.running_mean.copy_(
                        self.momentum * self.running_mean
                        + (1 - self.momentum) * mean)
                    self.running_var.copy_(
                        self.momentum * self.running_var
                        + (1 - self.momentum) * var)
            return y
        args = (x, self.weight, self.bias, self.eps, self.running_mean,
                self.running_var)
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (x, residual, self.weight, self.bias)):
            return _act_plain(*args, residual=residual, relu=relu)[0]
        return _act(*args, residual=residual, relu=relu)[0]

    def forward(self, x):
        return self.act(x, relu=False)


class FusedBatchNorm(BatchNormBase):
    """``nn.Module`` twin of the JAX package's ``PallasBatchNorm``: train
    mode runs ``batch_norm_train`` (the kernels on the card)."""

    def _train(self, x, residual, relu):
        return batch_norm_train(x, self.weight, self.bias, self.eps,
                                self.group, residual, relu)


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

    def _train(self, x, residual, relu):
        return ghost_batch_norm_train(x, self.weight, self.bias, self.eps,
                                      self.stats_rows, self.stats_dtype,
                                      self.group, self.parts, residual,
                                      relu)


class FlaxBatchNorm(BatchNormBase):
    """Counterpart of flax's ``nn.BatchNorm`` (``bn_impl='flax'``): the
    library's train-mode BatchNorm, then the residual add and ReLU as
    plain PyTorch, no kernel of this repo; the running statistics move
    with the biased variance and flax's momentum."""

    def _train(self, x, residual, relu):
        y, mean, var = _library_batch_norm_train(x, self.weight, self.bias,
                                                 self.eps, self.group)
        if residual is not None:
            y = y + residual
        return (F.relu(y) if relu else y), mean, var


def set_batch_norm_group(module: nn.Module, group, parts: int = 1) -> None:
    """Every train-mode BatchNorm of `module` (a whole model, or one layer
    of a trunk) reduces its statistics over `group`: a mesh's 'data'
    group, or its ``world_group`` for a layer H-sharded over 'model' with
    `parts` = the model axis's size (the ranks that hold pieces of the
    same images); None: this device alone."""
    for m in module.modules():
        if isinstance(m, BatchNormBase):
            m.group, m.parts = group, int(parts)


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
