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

from learning_embeddings_tpu.ops import PallasBatchNorm
from learning_embeddings_tpu.ops import batch_norm_train as jax_bn_train
from learning_embeddings_tpu.ops import bn_pallas
from learning_embeddings_tpu_torch.ops import bn
from learning_embeddings_tpu_torch.ops import FusedBatchNorm
from learning_embeddings_tpu_torch.ops import batch_norm_train

torch.set_num_threads(2)


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
    before = bn.CHANNELS_LAST_COPIES
    y_nchw, _, _ = batch_norm_train(_nchw(x).contiguous(), s, b)
    assert bn.CHANNELS_LAST_COPIES == before + 1
    np.testing.assert_array_equal(y_cl.numpy(), y_nchw.numpy())


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

    shapes = [(50176, 64), (12544, 64), (12544, 128), (12544, 256),
              (3136, 128), (3136, 256), (3136, 512), (784, 256),
              (784, 512), (784, 1024), (196, 512), (196, 2048)]
    for R, C in [(r * 32, c) for r, c in shapes] + [(12345, 100)]:
        block_r, block_c, n_splits = launch_shape(R, C, 132)
        assert block_r * block_c == 4096
        assert block_c & (block_c - 1) == 0 and block_c >= min(C, 128)
        n_cblocks, row_blocks = -(-C // block_c), -(-R // block_r)
        assert 1 <= n_splits <= row_blocks
        assert n_cblocks * n_splits >= min(4 * 132, n_cblocks * row_blocks)
        if (R, C) != (12345, 100):   # every ResNet-50 shape fills the card
            assert n_cblocks * n_splits >= 4 * 132
