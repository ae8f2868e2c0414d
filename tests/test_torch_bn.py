"""The port's train-mode BatchNorm (learning_embeddings_tpu_torch.ops.bn)
against the JAX package's ops/bn_pallas.py on the CPU: the reductions
against the XLA fallback and the Pallas kernels in interpret mode, values,
statistics and gradients of batch_norm_train, and FusedBatchNorm against
PallasBatchNorm. The port runs its plain versions here (CPU tensors)."""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from learning_embeddings_tpu.models.resnet import GhostBatchNorm as JaxGhost
from learning_embeddings_tpu.ops import PallasBatchNorm
from learning_embeddings_tpu.ops import batch_norm_train as jax_bn_train
from learning_embeddings_tpu.ops import bn_pallas
from learning_embeddings_tpu_torch.ops import bn
from learning_embeddings_tpu_torch.ops import FusedBatchNorm
from learning_embeddings_tpu_torch.ops import batch_norm_train
from learning_embeddings_tpu_torch.utils import profiling

torch.set_num_threads(2)

#: per-image (R, C) of the 12 BatchNorm shapes of ResNet-50@448
RESNET50_448_BN = [(50176, 64), (12544, 64), (12544, 128), (12544, 256),
                   (3136, 128), (3136, 256), (3136, 512), (784, 256),
                   (784, 512), (784, 1024), (196, 512), (196, 2048)]


def _nchw(x_nhwc):
    """NHWC numpy → NCHW torch view, channels_last in memory."""
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _interpret(kernel, n_in, *arrays):
    R, C = arrays[0].shape
    rb = 16
    return pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((1, C), jnp.float32)] * 2,
        grid=(R // rb,),
        in_specs=[pl.BlockSpec((rb, C), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)] * n_in,
        out_specs=[pl.BlockSpec((1, C), lambda i: (0, 0),
                                memory_space=pltpu.VMEM)] * 2,
        interpret=True,
    )(*[jnp.asarray(a) for a in arrays])


@pytest.mark.parametrize("R,C", [(64, 24), (96, 40)])
def test_plain_reductions_match_jax_fallback_and_interpret_kernels(R, C):
    rng = np.random.RandomState(R + C)
    x = rng.randn(R, C).astype(np.float32)
    dy = rng.randn(R, C).astype(np.float32)

    s, q = bn._stats(torch.from_numpy(x))
    s_x, q_x = bn_pallas._stats(jnp.asarray(x))           # XLA fallback
    s_k, q_k = _interpret(bn_pallas._stats_kernel, 1, x)  # Pallas kernel
    for ref_s, ref_q in ((s_x, q_x), (s_k[0], q_k[0])):
        np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(q.numpy(), np.asarray(ref_q), rtol=1e-5)

    sd, sp = bn._corr(torch.from_numpy(dy), torch.from_numpy(x))
    sd_x, sp_x = bn_pallas._corr(jnp.asarray(dy), jnp.asarray(x))
    sd_k, sp_k = _interpret(bn_pallas._corr_kernel, 2, dy, x)
    for ref_d, ref_p in ((sd_x, sp_x), (sd_k[0], sp_k[0])):
        np.testing.assert_allclose(sd.numpy(), np.asarray(ref_d), rtol=1e-5,
                                   atol=1e-5)
        # Σ(dy·x) sums terms of both signs: 1e-4 relative, as the JAX test
        np.testing.assert_allclose(sp.numpy(), np.asarray(ref_p), rtol=1e-4,
                                   atol=1e-4)


def _bn_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    C = shape[-1]
    x = (0.5 + 1.5 * rng.randn(*shape)).astype(np.float32)
    scale = (1 + 0.2 * rng.randn(C)).astype(np.float32)
    bias = (0.1 * rng.randn(C)).astype(np.float32)
    return x, scale, bias


def test_batch_norm_train_values_and_stats_match_jax():
    x, scale, bias = _bn_inputs((4, 5, 6, 8), 1)
    y, mean, var = batch_norm_train(_nchw(x), torch.from_numpy(scale),
                                    torch.from_numpy(bias), 1e-5)
    jy, jmean, jvar = jax_bn_train(jnp.asarray(x), jnp.asarray(scale),
                                   jnp.asarray(bias), 1e-5)
    np.testing.assert_allclose(_nhwc(y), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-5,
                               atol=1e-6)
    # the biased variance (not nn.BatchNorm2d's unbiased one)
    np.testing.assert_allclose(var.numpy(), x.reshape(-1, 8).var(0),
                               rtol=1e-4)
    assert y.is_contiguous(memory_format=torch.channels_last)


def test_batch_norm_train_grads_match_jax_grad():
    x, scale, bias = _bn_inputs((6, 4, 4, 8), 2)
    t = np.random.RandomState(3).randn(6, 4, 4, 8).astype(np.float32)

    def jax_loss(x, s, b):
        y, _, _ = jax_bn_train(x, s, b, 1e-5)
        return jnp.sum((y - t) ** 2)

    jg = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))

    tx = _nchw(x).clone().requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    y, _, _ = batch_norm_train(tx, ts, tb, 1e-5)
    ((y - _nchw(t)) ** 2).sum().backward()
    for got, ref in ((_nhwc(tx.grad), jg[0]), (ts.grad.numpy(), jg[1]),
                     (tb.grad.numpy(), jg[2])):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-4,
                                   atol=2e-4)


def test_non_channels_last_input_is_copied_counted_and_exact():
    x, scale, bias = _bn_inputs((3, 5, 5, 6), 4)
    s, b = torch.from_numpy(scale), torch.from_numpy(bias)
    y_cl, _, _ = batch_norm_train(_nchw(x), s, b)
    before = profiling.counts()["channels_last_copies"]
    y_nchw, _, _ = batch_norm_train(_nchw(x).contiguous(), s, b)
    assert profiling.counts()["channels_last_copies"] == before + 1
    np.testing.assert_array_equal(y_cl.numpy(), y_nchw.numpy())


def _zero_variance_inputs():
    """Channel 2 holds 64 ± 2⁻⁷ in equal numbers: its sums are exact, each
    x² rounds to 4096 ± 1, so Σx²/R − mean² is exactly 0 on both sides,
    though x − mean is not. Integer dy keeps Σdy·x exact too."""
    rng = np.random.RandomState(5)
    x, scale, bias = _bn_inputs((4, 4, 4, 6), 5)
    signs = np.where(rng.permutation(64) % 2, 1.0, -1.0).reshape(4, 4, 4)
    x[..., 2] = 64 + signs * 2.0 ** -7
    dy = rng.randint(-3, 4, x.shape).astype(np.float32)
    return x, dy, scale, bias


def _jax_dx_at_zero_variance(route, x, dy, scale, bias):
    """(dx, var) of the JAX twin: the custom VJP of ``batch_norm_train``
    (no clamp; slope 1) or ``GhostBatchNorm`` over all rows under
    ``jax.grad`` (``jnp.maximum``'s slope, ½ at 0)."""
    if route == "fused":
        (_, _, var), vjp = jax.vjp(
            lambda xx: jax_bn_train(xx, scale, bias, 1e-5), jnp.asarray(x))
        zeros = jnp.zeros(x.shape[-1])
        return np.asarray(vjp((jnp.asarray(dy), zeros, zeros))[0]), var
    m = JaxGhost(use_running_average=False, dtype=jnp.float32, stats_rows=-1,
                 stats_dtype=jnp.float32, momentum=0.0)
    stats = {"mean": jnp.zeros(x.shape[-1]), "var": jnp.zeros(x.shape[-1])}

    def f(xx):
        y, new = m.apply({"params": {"scale": scale, "bias": bias},
                          "batch_stats": stats}, xx, mutable=["batch_stats"])
        return jnp.sum(y * dy), new["batch_stats"]["var"]
    dx, var = jax.grad(f, has_aux=True)(jnp.asarray(x))
    return np.asarray(dx), var


@pytest.mark.parametrize("route", ["fused", "ghost"])
def test_dx_at_zero_variance_takes_its_twins_slope(route):
    """The one difference between the fused route and the ghost route over
    all rows in f32: at a channel whose variance is exactly 0, the fused
    route's dx takes slope 1 through max(var, 0), as the JAX custom VJP,
    and the ghost route's ½, as JAX's autodiff of ``jnp.maximum``. Each
    equals its twin within 1e-3 of max|dx| (JAX's autodiff adds 2x·dvar/n
    and −2·mean·dvar/n apart, which cancel at mean 64, 1.4e-4 here) and
    misses the other twin by a tenth of it."""
    x, dy, scale, bias = _zero_variance_inputs()
    tx = _nchw(x).clone().requires_grad_(True)
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    y, _, var = (batch_norm_train(tx, ts, tb) if route == "fused" else
                 bn.ghost_batch_norm_train(tx, ts, tb, 1e-5, -1))
    y.backward(_nchw(dy))
    got = _nhwc(tx.grad)
    want, want_var = _jax_dx_at_zero_variance(route, x, dy, scale, bias)
    other, _ = _jax_dx_at_zero_variance(
        "ghost" if route == "fused" else "fused", x, dy, scale, bias)
    assert var[2].item() == 0.0 and float(want_var[2]) == 0.0
    tol = 1e-3 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert np.abs(got[..., 2] - other[..., 2]).max() > 100 * tol


def test_fused_batch_norm_module_matches_pallas_batch_norm():
    x, scale, bias = _bn_inputs((8, 6, 6, 12), 5)
    rng = np.random.RandomState(6)
    ra_mean = (0.3 * rng.randn(12)).astype(np.float32)
    ra_var = (0.5 + rng.rand(12)).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(ra_mean),
                                 "var": jnp.asarray(ra_var)}}

    m = FusedBatchNorm(12, dtype=torch.float32)
    m.load_state_dict({"weight": torch.from_numpy(scale),
                       "bias": torch.from_numpy(bias),
                       "running_mean": torch.from_numpy(ra_mean),
                       "running_var": torch.from_numpy(ra_var)})

    # eval mode: running statistics folded into the affine
    jm_eval = PallasBatchNorm(use_running_average=True, dtype=jnp.float32)
    jy = jm_eval.apply(variables, jnp.asarray(x))
    y = m.eval()(_nchw(x))
    np.testing.assert_allclose(_nhwc(y), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)

    # train mode: output and the running-stat update (momentum, biased var)
    jm = PallasBatchNorm(use_running_average=False, dtype=jnp.float32)
    jy, mutated = jm.apply(variables, jnp.asarray(x),
                           mutable=["batch_stats"])
    y = m.train()(_nchw(x))
    np.testing.assert_allclose(_nhwc(y), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    xr = x.reshape(-1, 12)
    np.testing.assert_allclose(m.running_var.numpy(),
                               0.9 * ra_var + 0.1 * xr.var(0), rtol=1e-5)


def test_cpu_path_never_imports_the_triton_module(monkeypatch):
    monkeypatch.delitem(sys.modules,
                        "learning_embeddings_tpu_torch.ops.bn_triton",
                        raising=False)
    x, scale, bias = _bn_inputs((2, 3, 3, 4), 7)
    tx = _nchw(x).clone().requires_grad_(True)
    y, _, _ = batch_norm_train(tx, torch.from_numpy(scale),
                               torch.from_numpy(bias))
    y.sum().backward()
    assert "learning_embeddings_tpu_torch.ops.bn_triton" not in sys.modules
    assert "triton" not in sys.modules


def test_kernel_launch_shape_fills_the_card_for_resnet50_shapes():
    """Launch geometry (pure Python) for the 12 per-image (R, C) BatchNorm
    shapes of ResNet-50@448 at batch 32, plus a ragged one, on 132 SMs."""
    from learning_embeddings_tpu_torch.ops.bn_triton import launch_shape

    for R, C in [(r * 32, c) for r, c in RESNET50_448_BN] + [(12345, 100)]:
        block_r, block_c, n_splits = launch_shape(R, C, 132)
        assert block_r * block_c == 4096
        assert block_c & (block_c - 1) == 0 and block_c >= min(C, 128)
        n_cblocks, row_blocks = -(-C // block_c), -(-R // block_r)
        assert 1 <= n_splits <= row_blocks
        assert n_cblocks * n_splits >= min(4 * 132, n_cblocks * row_blocks)
        if (R, C) != (12345, 100):   # every ResNet-50 shape fills the card
            assert n_cblocks * n_splits >= 4 * 132


def _old_bwd_epilogue(x, dy, scale, mean, inv, sdy, sdyx, R):
    """The plain route's f32 dx passes as ops/bn.py wrote them before the
    dx kernel: the oracle of `_dx`."""
    pc = bn._per_channel
    sdyxh = (sdyx - mean * sdy) * inv
    g = scale.float() * inv
    xhat = (x.float() - pc(mean, x)).mul_(pc(inv, x))
    return (dy.to(torch.float32, copy=True).sub_(pc(sdy / R, x))
            .sub_(xhat.mul_(pc(sdyxh / R, x))).mul_(pc(g, x)))


def _old_ghost_bwd_epilogue(x, dy, scale, mean, inv, d, sdy, sdyx, rows, n,
                            round_bf16):
    """The ghost route's f32 dx passes as ops/bn.py wrote them before the
    dx kernel (the JAX package's autodiff written out)."""
    pc = bn._per_channel
    g = scale.float() * inv
    da = sdyx - mean * sdy
    slope = (d > 0).float() + 0.5 * (d == 0).float()
    dvar = -0.5 * inv ** 3 * scale.float() * da * slope
    dmean = -sdy * g - 2 * mean * dvar
    dx = dy.to(torch.float32, copy=True).mul_(pc(g, x))
    xs = x[:rows]
    if round_bf16:
        xs = xs.to(torch.bfloat16)
    dx[:rows].add_(pc(dmean / n, x)).add_(
        torch.mul(xs.float(), pc(2 * dvar / n, x)))
    return dx


@pytest.mark.parametrize("route", ["plain", "plain_mesh", "ghost",
                                   "ghost_bf16_x", "ghost_mesh"])
def test_dx_reproduces_the_old_f32_epilogues(route):
    """`_dx` (the CPU's `_dx_plain`) against the f32 expressions it
    replaced, on seeded f32 inputs: the plain and the ghost routes, the
    latter with a row prefix, x rounded to bf16 and channels whose
    variance is clamped (slope 0) or exactly 0 (slope ½); on a mesh dx
    takes the global sums and the scale's and bias's gradients this
    rank's own. Both sides round in f32 in another order: 1e-5 of the
    magnitude of the terms each element sums."""
    rng = np.random.RandomState(11)
    N, C, H, W = 6, 8, 3, 5
    x = _nchw((0.5 + 1.5 * rng.randn(N, H, W, C)).astype(np.float32))
    dy = _nchw(rng.randn(N, H, W, C).astype(np.float32))
    scale = torch.from_numpy((1 + 0.2 * rng.randn(C)).astype(np.float32))
    mesh = route.endswith("_mesh")
    ghost = route.startswith("ghost")
    images = 4 if ghost else N          # the rows the statistics cover
    x2, dy2 = bn._rows(x), bn._rows(dy)
    per_img = H * W
    s, q = bn._stats_plain(x2[:images * per_img])
    sdy_own, sdyx_own = bn._corr_plain(dy2, x2)
    parts = 2 if mesh else 1            # another rank's rows, added
    sdy = sdy_own + (0.7 * sdy_own + 0.1 if mesh else 0)
    sdyx = sdyx_own + (-0.4 * sdyx_own + 0.2 if mesh else 0)
    n = images * per_img * parts
    mean, msq = s / (images * per_img), q / (images * per_img)
    d = msq - mean * mean
    if ghost:
        d[0], d[1] = -1e-3, 0.0         # clamped, and at the clamp
    inv = torch.rsqrt(torch.clamp_min(d, 0.0) + 1e-5)
    round_x = route == "ghost_bf16_x"
    dy_before, x_before = dy.clone(), x.clone()
    got, dscale, dbias = bn._dx(dy, x, scale, mean, inv, sdy, sdyx, sdy_own,
                                sdyx_own, n, images * per_img,
                                d if ghost else None, round_x)
    if ghost:
        want = _old_ghost_bwd_epilogue(x, dy, scale, mean, inv, d, sdy, sdyx,
                                       images, n, round_x)
    else:
        want = _old_bwd_epilogue(x, dy, scale, mean, inv, sdy, sdyx, n)
    pc = bn._per_channel
    g = pc((scale * inv).abs(), x)
    terms = (dy.abs() * g + pc((scale * inv * sdy / n).abs(), x)
             + (x - pc(mean, x)).abs() * g * pc(
                 (inv * inv * (sdyx.abs() + (mean * sdy).abs()) / n), x))
    assert got.dtype == x.dtype and got.shape == x.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert bool(((got - want).abs() <= 1e-5 * terms).all())
    # the scale's and bias's gradients come from this rank's sums alone
    torch.testing.assert_close(dscale, (sdyx_own - mean * sdy_own) * inv)
    assert torch.equal(dbias, sdy_own)
    if ghost:   # past the prefix dx is dy·g alone
        np.testing.assert_array_equal(
            got[images:].numpy(), (dy * pc(scale * inv, x))[images:].numpy())
    assert torch.equal(dy, dy_before) and torch.equal(x, x_before)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dx_plain_rounds_once_to_the_dtype_of_its_output(dtype):
    """`_dx_plain` computes in f32 and rounds once at the end: in bf16 its
    dx is the f32 dx rounded, into a given output or a new one like x."""
    rng = np.random.RandomState(12)
    R, C = 40, 16
    x2 = torch.from_numpy(rng.randn(R, C).astype(np.float32)).to(dtype)
    dy2 = torch.from_numpy(rng.randn(R, C).astype(np.float32)).to(dtype)
    v = [torch.from_numpy(rng.rand(C).astype(np.float32) + 0.5)
         for _ in range(7)]
    f32, ds32 = bn._dx_plain(dy2.float(), x2.float(), *v, R, R)
    got, ds = bn._dx_plain(dy2, x2, *v, R, R)
    assert got.dtype == dtype and torch.equal(got, f32.to(dtype))
    assert torch.equal(ds, ds32)
    out = torch.empty_like(x2)
    assert bn._dx_plain(dy2, x2, *v, R, R, out=out)[0] is out
    assert torch.equal(out, got)


def test_dx_raises_off_the_cpu_and_the_card():
    x = torch.empty((2, 3, 2, 2), device="meta",
                    memory_format=torch.channels_last)
    v = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="no BatchNorm dx path"):
        bn._dx(x, x, v, v, v, v, v, v, v, 8, 8)


def test_dx_launch_shape_stays_within_the_grid_limits():
    """bn_dx's geometry (pure Python) at ResNet-50@448's shapes at batch
    128 and 2 and a ragged one, on 132 SMs: its tiles, at most 65,535 row
    splits (the grid's second dimension) and no more than there are row
    blocks."""
    from learning_embeddings_tpu_torch.ops import bn_triton

    for R, C in [(r * b, c) for r, c in RESNET50_448_BN
                 for b in (128, 2)] + [
            (12345, 100), (1, 3)]:
        block_r, block_c, n_splits = bn_triton.launch_shape(
            R, C, 132, bn_triton._DX_TILE_ELEMS,
            bn_triton._DX_PROGRAMS_PER_SM)
        assert block_r * block_c == bn_triton._DX_TILE_ELEMS
        assert block_c & (block_c - 1) == 0 and block_c >= min(C, 128)
        assert 1 <= n_splits <= min(-(-R // block_r), 65535)


def _old_fwd_epilogue(x, scale, bias, eps, s, q, n, round_bf16=False):
    """The forward epilogue as ops/bn.py wrote it before the fused pass:
    the f32 fold, then y = x·a + b in x's dtype (the oracle of `_act`)."""
    mean, msq = s / n, q / n
    if round_bf16:
        mean = mean.to(torch.bfloat16).float()
        msq = msq.to(torch.bfloat16).float()
    d = msq - mean * mean
    var = torch.clamp_min(d, 0.0)
    inv = torch.rsqrt(var + eps)
    a = scale.float() * inv
    b = bias.float() - mean * a
    y = torch.addcmul(bn._per_channel(b.to(x.dtype), x), x,
                      bn._per_channel(a.to(x.dtype), x))
    return y, mean, var, inv, d


#: the train routes of the port: (stats_rows, stats_dtype) or None for
#: the fused route
ACT_ROUTES = {"fused": None, "ghost_f32": (2, torch.float32),
              "ghost_bf16": (2, torch.bfloat16)}


def _train_bn(route, x, scale, bias, residual=None, relu=False):
    ghost = ACT_ROUTES[route]
    if ghost is None:
        return batch_norm_train(x, scale, bias, 1e-5, None, residual, relu)
    return bn.ghost_batch_norm_train(x, scale, bias, 1e-5, *ghost,
                                     residual=residual, relu=relu)


def _act_inputs(seed, dtype=torch.bfloat16, shape=(4, 6, 5, 8)):
    x, scale, bias = _bn_inputs(shape, seed)
    r = np.random.RandomState(seed + 1).randn(*shape).astype(np.float32)
    return (_nchw(x).to(dtype), torch.from_numpy(scale),
            torch.from_numpy(bias), _nchw(r).to(dtype))


@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("route", list(ACT_ROUTES))
def test_act_is_bit_equal_to_the_unfused_chain(route, residual, relu):
    """`_act_plain` (the CPU's route of `_act`) in bf16, through each
    train route's Function, against the unfused chain written out: the
    old epilogue from K1's sums over the statistics' rows, then + r and
    F.relu. Output and statistics equal bit for bit."""
    x, scale, bias, r = _act_inputs(21)
    ghost = ACT_ROUTES[route]
    rows = (ghost[0] if ghost else x.shape[0]) * 6 * 5
    x2 = bn._rows(x)[:rows]
    round_bf16 = bool(ghost) and ghost[1] == torch.bfloat16
    s, q = bn._stats_plain(x2.to(torch.bfloat16) if round_bf16 else x2,
                           round_bf16)
    want, mean, var, _, _ = _old_fwd_epilogue(x, scale, bias, 1e-5, s, q,
                                              rows, round_bf16)
    if residual:
        want = want + r
    if relu:
        want = torch.nn.functional.relu(want)
    got, gmean, gvar = _train_bn(route, x, scale, bias,
                                 r if residual else None, relu)
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    assert torch.equal(gmean, mean) and torch.equal(gvar, var)


@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("route", list(ACT_ROUTES))
def test_act_gradients_equal_the_chains(route, residual, relu):
    """The gradients of x, the scale, the bias and the residual through
    the fused Functions (the ReLU's mask and the residual's gradient in
    the Function's backward) equal those of the Function without them
    followed by autograd's add and ReLU, bit for bit, in bf16."""
    x, scale, bias, r = _act_inputs(22)
    dy = torch.from_numpy(np.random.RandomState(23).randn(
        *x.shape).astype(np.float32)).to(torch.bfloat16)
    grads = []
    for fused in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias, r)]
        tx, ts, tb, tr = leaves
        res = tr if residual else None
        if fused:
            y = _train_bn(route, tx, ts, tb, res, relu)[0]
        else:
            y = _train_bn(route, tx, ts, tb)[0]
            if residual:
                y = y + res
            if relu:
                y = torch.nn.functional.relu(y)
        y.backward(dy)
        grads.append([t.grad for t in leaves])
    for name, want, got in zip(("x", "scale", "bias", "residual"), *grads):
        if name == "residual" and not residual:
            assert want is None and got is None
            continue
        assert got.dtype == want.dtype, name
        assert torch.equal(got, want), name


def test_act_eval_is_the_old_eval_expression():
    """Eval mode without a gradient (`_act`, the kernel's route) and with
    one (the plain chain under autograd) both equal the running
    statistics' fold written out, with the residual and the ReLU; the
    gradients of the chain reach the weight, the bias and the input."""
    x, scale, bias, r = _act_inputs(24)
    rng = np.random.RandomState(25)
    m = FusedBatchNorm(8, dtype=torch.bfloat16)
    m.load_state_dict({"weight": scale, "bias": bias,
                       "running_mean": torch.from_numpy(
                           (0.3 * rng.randn(8)).astype(np.float32)),
                       "running_var": torch.from_numpy(
                           (0.5 + rng.rand(8)).astype(np.float32))})
    m.eval()
    inv = torch.rsqrt(m.running_var + m.eps)
    a = m.weight * inv
    b = m.bias - m.running_mean * a
    pc = bn._per_channel
    want = torch.nn.functional.relu(torch.addcmul(
        pc(b.to(x.dtype), x), x, pc(a.to(x.dtype), x)) + r).detach()
    with torch.no_grad():
        assert torch.equal(m.act(x, r), want)
        assert torch.equal(m(x), torch.addcmul(pc(b.to(x.dtype), x), x,
                                               pc(a.to(x.dtype), x)))
    tx = x.clone().requires_grad_(True)
    got = m.act(tx, r)
    assert torch.equal(got.detach(), want)
    got.float().sum().backward()
    assert m.weight.grad is not None and m.bias.grad is not None
    assert torch.equal(tx.grad, (want > 0).to(x.dtype) * pc(
        a.detach().to(x.dtype), x))


def _count_act(monkeypatch):
    calls = []
    act = bn._act

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return act(*args, **kw)
    monkeypatch.setattr(bn, "_act", counted)
    return calls


def test_flax_route_and_eval_with_a_gradient_take_the_chain(monkeypatch):
    """The library's train route and eval mode where autograd records run
    the plain chain: neither reaches `_act` (the kernel's route); the
    port's train routes and eval mode without a gradient reach it once a
    BatchNorm."""
    x, scale, bias, r = _act_inputs(26)
    calls = _count_act(monkeypatch)
    for m in (bn.FlaxBatchNorm(8), FusedBatchNorm(8),
              bn.GhostBatchNorm(8, stats_rows=2)):
        m.train().act(x.clone().requires_grad_(True), r).sum().backward()
    assert len(calls) == 2
    m = FusedBatchNorm(8).eval()
    m.act(x.clone().requires_grad_(True), r)
    assert len(calls) == 2
    with torch.no_grad():
        m.act(x, r)
    assert len(calls) == 3
    flax = bn.FlaxBatchNorm(8).train()
    y = flax.act(x, r)
    ref, _, _ = bn._library_batch_norm_train(x, flax.weight, flax.bias,
                                             flax.eps)
    assert torch.equal(y, torch.nn.functional.relu(ref + r))


def test_act_raises_off_the_cpu_and_the_card():
    x = torch.empty((2, 3, 2, 2), device="meta",
                    memory_format=torch.channels_last)
    v = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="no BatchNorm forward path"):
        bn._act(x, v, v, 1e-5, v, v, 8)


def test_act_launch_shape_stays_within_the_grid_limits():
    """bn_act's geometry (pure Python) at ResNet-50@448's shapes at batch
    128 and 2 and a ragged one, on 132 SMs: its tiles, at most 65,535 row
    splits and no more than there are row blocks."""
    from learning_embeddings_tpu_torch.ops import bn_triton

    for R, C in [(r * b, c) for r, c in RESNET50_448_BN
                 for b in (128, 2)] + [(12345, 100), (1, 3)]:
        block_r, block_c, n_splits = bn_triton.launch_shape(
            R, C, 132, bn_triton._ACT_TILE_ELEMS,
            bn_triton._ACT_PROGRAMS_PER_SM)
        assert block_r * block_c == bn_triton._ACT_TILE_ELEMS
        assert block_c & (block_c - 1) == 0 and block_c >= min(C, 128)
        assert 1 <= n_splits <= min(-(-R // block_r), 65535)
