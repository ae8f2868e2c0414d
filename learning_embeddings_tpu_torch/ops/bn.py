"""Train-mode BatchNorm whose reductions run in hand-written kernels.

Port of ``learning_embeddings_tpu/ops/bn_pallas.py``. The two per-channel
reductions go through ``_stats`` / ``_corr``: on a CUDA tensor they launch
the Triton kernels of ``ops/bn_triton.py`` (always; there is no fallback on
the card), on a CPU tensor they run the plain PyTorch versions below. The
normalisation and the dx expression stay plain elementwise PyTorch.

Same function as the JAX package computes:

* statistics from Σx and Σx² (not Welford): mean = Σx/R and the **biased**
  variance max(Σx²/R − mean², 0) — the running variance is updated with
  it, unlike ``nn.BatchNorm2d``'s unbiased one;
* the forward folds into a = scale·rsqrt(var + eps), b = bias − mean·a in
  f32, then y = x·a + b in the activation dtype;
* the backward computes dx in f32 and casts it to x's dtype;
* flax momentum: running = 0.9·running + 0.1·batch; eps 1e-5.

Layout: channels sit at dim 1 (PyTorch's NCHW order), and the kernels read
each activation as a row-major (R = N·H·W, C) matrix, which is a free view
of a channels_last tensor. Any other layout costs an explicit copy, counted
in ``CHANNELS_LAST_COPIES``.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["batch_norm_train", "FusedBatchNorm", "CHANNELS_LAST_COPIES"]

#: channels_last copies made to view an input as an (R, C) matrix
CHANNELS_LAST_COPIES = 0


def _stats_plain(x2):
    xf = x2.float()
    return xf.sum(0), (xf * xf).sum(0)


def _corr_plain(dy2, x2):
    dyf = dy2.float()
    return dyf.sum(0), (dyf * x2.float()).sum(0)


def _stats(x2):
    """Σx, Σx² over the rows of x2 (R, C): kernel on the card, plain on
    the CPU."""
    if x2.is_cuda:
        from . import bn_triton
        return bn_triton.bn_stats(x2)
    if x2.device.type == "cpu":
        return _stats_plain(x2)
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


class FusedBatchNorm(nn.Module):
    """``nn.Module`` twin of the JAX package's ``PallasBatchNorm``: train
    mode runs ``batch_norm_train`` (the kernels on the card), eval mode
    folds the running statistics the same way. Parameters and buffers use
    torchvision's names (weight, bias, running_mean, running_var).

    `dtype` is the activation dtype the input is cast to; parameters and
    running statistics stay f32."""

    #: flax's momentum (the running value keeps 0.9 of itself) and eps
    momentum = 0.9
    eps = 1e-5

    def __init__(self, num_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        x = x.to(self.dtype)
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps)
            a = self.weight * inv
            b = self.bias - self.running_mean * a
            return torch.addcmul(_per_channel(b.to(self.dtype), x), x,
                                 _per_channel(a.to(self.dtype), x))
        y, mean, var = batch_norm_train(x, self.weight, self.bias, self.eps)
        with torch.no_grad():
            self.running_mean.copy_(self.momentum * self.running_mean
                                    + (1 - self.momentum) * mean)
            self.running_var.copy_(self.momentum * self.running_var
                                   + (1 - self.momentum) * var)
        return y
