"""The port's model zoo against the JAX package's on the CPU, in float32,
from weights carried over with ``models/jax_import.py``: AlexNet (64²) and
VGG11BN (32²) logits in eval and train mode, their running statistics and
train-mode gradients; the s2d stem (kernel conversion, channel order, the
whole model, and the port's s2d model against its own conv7 model);
``GhostBatchNorm`` for stats_rows ∈ {2, all} × stats_dtype ∈ {float32,
bfloat16} (the full-rows f32 case also against ``FusedBatchNorm``); and
the flax route's library BatchNorm with the biased running variance.

Tolerances (f32 unless named):
* eval logits rtol/atol 1e-4 (conv sums in another order);
* train logits and running statistics rtol 1e-4, atol 1e-5 (the batch
  statistics of 4 images);
* gradients: each tensor within 1e-4 of its largest entry;
* s2d against conv7: the same convolution taps summed in another order,
  within 1e-5 of max|logit|; the converted kernel is exact;
* GhostBatchNorm f32: y, dx, dscale, dbias and the running statistics
  within 1e-5 of each tensor's largest entry; bf16 statistics: the
  forward the same (both sides round the same f32 sums to bf16), the
  gradients within 2e-2 of each tensor's largest entry, because JAX's
  autodiff rounds the statistics' cotangents to bf16 where the port keeps
  them in f32; full rows f32 against FusedBatchNorm within 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from learning_embeddings_tpu.models.heads import HierarchicalCNN as JaxCNN
from learning_embeddings_tpu.models.resnet import (
    GhostBatchNorm as JaxGhost, s2d_stem_kernel as jax_s2d_kernel)
from learning_embeddings_tpu_torch.models import (HierarchicalCNN,
                                                  init_params_,
                                                  state_dict_from_jax)
from learning_embeddings_tpu_torch.models.resnet import (BACKBONES,
                                                         s2d_stem_kernel,
                                                         space_to_depth)
from learning_embeddings_tpu_torch.ops import bn
from learning_embeddings_tpu_torch.ops.bn import (FlaxBatchNorm,
                                                  FusedBatchNorm,
                                                  GhostBatchNorm)

torch.set_num_threads(2)

LEVELS = (2, 4, 8)
STAGES18 = (2, 2, 2, 2)
SIZES = {"alexnet": 64, "vgg11_bn": 32}


def _perturbed(tree, rng):
    """BatchNorm scale/bias and running statistics moved off their init
    values, and conv biases off 0, so that the comparison sees them."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v) for k, v in node.items()}
        if "scale" in out:
            n = out["scale"].shape
            out["scale"] = (1 + 0.2 * rng.randn(*n)).astype(np.float32)
            out["bias"] = (0.1 * rng.randn(*n)).astype(np.float32)
        elif "bias" in out:
            out["bias"] = (0.05 * rng.randn(*out["bias"].shape)) \
                .astype(np.float32)
        if "mean" in out:
            n = out["mean"].shape
            out["mean"] = (0.1 * rng.randn(*n)).astype(np.float32)
            out["var"] = (0.5 + rng.rand(*n)).astype(np.float32)
        return out
    return walk(tree)


def _jax_pair(backbone, size, stages=None, **kw):
    jm = JaxCNN(backbone=backbone, levels=LEVELS, dtype=jnp.float32, **kw)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, size, size, 3)), train=False))
    rng = np.random.RandomState(0)
    params = _perturbed(jax.tree_util.tree_map(np.asarray,
                                               dict(v["params"])), rng)
    stats = _perturbed(jax.tree_util.tree_map(
        np.asarray, dict(v.get("batch_stats", {}))), rng)
    model = HierarchicalCNN(backbone, LEVELS, dtype=torch.float32, **kw)
    model.load_state_dict(state_dict_from_jax(params, stats, stages or ()),
                          strict=True)
    model.to(memory_format=torch.channels_last)
    x = rng.rand(4, size, size, 3).astype(np.float32)
    return jm, params, stats, model, x


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.fixture(scope="module", params=sorted(SIZES))
def zoo_pair(request):
    backbone = request.param
    return (backbone,) + _jax_pair(backbone, SIZES[backbone])


def test_backbones_are_the_jax_zoo():
    # the JAX zoo, and the port's own ViT-L/16 (models/vit.py) and Swin-L
    # (models/swin.py), which the JAX package does not have
    from learning_embeddings_tpu.models.resnet import BACKBONES as JAX
    assert sorted(BACKBONES) == sorted(set(JAX) | {"vit_l_16", "swin_l"})
    assert "vit_l_16" not in JAX and "swin_l" not in JAX
    for name in ("alexnet", "vgg11_bn"):
        trunk = BACKBONES[name]()
        assert trunk.feature_dim == JAX[name]().feature_dim


def test_zoo_eval_logits_match(zoo_pair):
    _, jm, params, stats, model, x = zoo_pair
    ref = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                   train=False)
    with torch.no_grad():
        got = model.eval()(_nchw(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_zoo_train_logits_and_running_stats_match(zoo_pair):
    backbone, jm, params, stats, model, x = zoo_pair
    ref, mutated = jm.apply({"params": params, "batch_stats": stats},
                            jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    model.load_state_dict(state_dict_from_jax(params, stats))
    with torch.no_grad():
        got = model.train()(_nchw(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-5)
    want = state_dict_from_jax(params,
                               jax.device_get(mutated.get("batch_stats", {})))
    have = model.state_dict()
    names = [k for k in want if "running" in k]
    assert len(names) == (0 if backbone == "alexnet" else 16)
    for k in names:
        np.testing.assert_allclose(have[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_zoo_train_gradients_match(zoo_pair):
    _, jm, params, stats, model, x = zoo_pair
    w = np.random.RandomState(3).randn(len(x), sum(LEVELS)) \
        .astype(np.float32)

    def loss(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats},
                          jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
        return jnp.sum(out * w)
    grads = state_dict_from_jax(jax.device_get(jax.grad(loss)(params)),
                                stats)
    model.load_state_dict(state_dict_from_jax(params, stats))
    model.train().zero_grad()
    (model(_nchw(x)) * torch.from_numpy(w)).sum().backward()
    checked = 0
    for k, p in model.named_parameters():
        ref = grads[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-12,
                                   err_msg=k)
        checked += 1
    assert checked == len(list(model.parameters()))


# ----------------------------------------------------------------------
# the s2d stem
# ----------------------------------------------------------------------
def test_s2d_stem_kernel_equals_jax():
    w = np.random.RandomState(0).randn(7, 7, 3, 64).astype(np.float32)
    want = jax_s2d_kernel(w)                         # (4, 4, 12, 64) HWIO
    got = s2d_stem_kernel(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(got.numpy(), want.transpose(3, 2, 0, 1))


def test_space_to_depth_keeps_the_jax_channel_order():
    x = torch.randn(2, 3, 6, 8).contiguous(memory_format=torch.channels_last)
    z = space_to_depth(x)
    assert z.shape == (2, 12, 3, 4)
    assert z.is_contiguous(memory_format=torch.channels_last)
    for u in range(2):
        for v in range(2):
            for c in range(3):
                assert torch.equal(z[:, (u * 2 + v) * 3 + c],
                                   x[:, c, u::2, v::2])
    with pytest.raises(ValueError, match="even"):
        space_to_depth(torch.zeros(1, 3, 5, 8))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_s2d_model_matches_jax(train):
    jm, params, stats, model, x = _jax_pair("resnet18", 32, STAGES18,
                                            stem="s2d")
    assert tuple(model.trunk.conv1.weight.shape) == (64, 12, 4, 4)
    if train:
        ref, mutated = jm.apply({"params": params, "batch_stats": stats},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
    else:
        ref = jm.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model.train(train)(_nchw(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)
    if train:
        want = state_dict_from_jax(params, jax.device_get(
            mutated["batch_stats"]), STAGES18)
        for k, v in model.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                           rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_s2d_model_equals_conv7_model(train):
    conv7 = HierarchicalCNN("resnet18", LEVELS, dtype=torch.float32)
    init_params_(conv7, torch.Generator().manual_seed(0))
    s2d = HierarchicalCNN("resnet18", LEVELS, dtype=torch.float32,
                          stem="s2d")
    sd = conv7.state_dict()
    sd["trunk.conv1.weight"] = s2d_stem_kernel(sd["trunk.conv1.weight"])
    s2d.load_state_dict(sd, strict=True)
    x = torch.rand(4, 3, 64, 64).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        a = conv7.to(memory_format=torch.channels_last).train(train)(x)
        b = s2d.to(memory_format=torch.channels_last).train(train)(x)
    assert (a - b).abs().max() <= 1e-5 * a.abs().max()
    if train:
        for k, v in conv7.state_dict().items():
            if "running" in k:
                torch.testing.assert_close(s2d.state_dict()[k], v,
                                           rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# GhostBatchNorm and the bf16 statistics
# ----------------------------------------------------------------------
def _ghost_inputs(seed=0, shape=(6, 5, 4, 12)):
    rng = np.random.RandomState(seed)
    x = (0.5 + 2 * rng.randn(*shape)).astype(np.float32)        # NHWC
    dy = rng.randn(*shape).astype(np.float32)
    scale = (1 + 0.2 * rng.randn(shape[-1])).astype(np.float32)
    bias = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    ra_mean = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    ra_var = (0.5 + rng.rand(shape[-1])).astype(np.float32)
    return x, dy, scale, bias, ra_mean, ra_var


def _jax_ghost(x, dy, scale, bias, ra_mean, ra_var, rows, dtype):
    m = JaxGhost(use_running_average=False, dtype=jnp.float32,
                 stats_rows=rows, stats_dtype=dtype)
    stats = {"mean": ra_mean, "var": ra_var}

    def f(xx, p):
        y, mut = m.apply({"params": p, "batch_stats": stats}, xx,
                         mutable=["batch_stats"])
        return jnp.sum(y * dy), (y, mut["batch_stats"])
    (_, (y, new)), (dx, dp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                          {"scale": scale, "bias": bias})
    return {k: np.asarray(v) for k, v in dict(
        y=y, dx=dx, dscale=dp["scale"], dbias=dp["bias"],
        mean=new["mean"], var=new["var"]).items()}


def _port_norm(module, x, dy, scale, bias, ra_mean, ra_var):
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(scale))
        module.bias.copy_(torch.from_numpy(bias))
        module.running_mean.copy_(torch.from_numpy(ra_mean))
        module.running_var.copy_(torch.from_numpy(ra_var))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = module.train()(tx)
    y.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    nhwc = (lambda t: t.detach().permute(0, 2, 3, 1).numpy())
    return dict(y=nhwc(y), dx=nhwc(tx.grad),
                dscale=module.weight.grad.numpy(),
                dbias=module.bias.grad.numpy(),
                mean=module.running_mean.numpy(),
                var=module.running_var.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [2, -1], ids=["rows2", "all_rows"])
def test_ghost_batch_norm_matches_jax(rows, dtype):
    args = _ghost_inputs()
    want = _jax_ghost(*args, rows, getattr(jnp, dtype))
    got = _port_norm(GhostBatchNorm(12, torch.float32, rows,
                                    getattr(torch, dtype)), *args)
    grad_tol = 1e-5 if dtype == "float32" else 2e-2
    for k in ("y", "mean", "var", "dx", "dscale", "dbias"):
        tol = grad_tol if k.startswith("d") else 1e-5
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=tol * np.abs(want[k]).max(),
                                   err_msg=k)


def test_ghost_gradient_is_zero_where_the_variance_clamps():
    """bf16 statistics of a constant 1.1 channel: the mean rounds to
    1.1015625 and the mean of x² to 1.2109375 < 1.1015625², so
    max(var, 0) clamps, and no gradient flows through the variance; the
    port and JAX agree there too."""
    x, dy, scale, bias, ra_mean, ra_var = _ghost_inputs(1)
    x[:, :, :, 3] = 1.1
    want = _jax_ghost(x, dy, scale, bias, ra_mean, ra_var, 2, jnp.bfloat16)
    got = _port_norm(GhostBatchNorm(12, torch.float32, 2, torch.bfloat16),
                     x, dy, scale, bias, ra_mean, ra_var)
    assert want["var"][3] == pytest.approx(0.9 * ra_var[3])
    # through the variance, inv³ = (1e-5)^-1.5 would move dx by ~1e7; the
    # mean's cotangent still flows, rounded to bf16 on the JAX side
    np.testing.assert_allclose(got["y"][..., 3], want["y"][..., 3],
                               rtol=1e-5, atol=1e-5)
    for k in ("dx", "dscale", "dbias"):
        np.testing.assert_allclose(
            got[k][..., 3], want[k][..., 3], rtol=0,
            atol=2e-2 * np.abs(want[k][..., 3]).max(), err_msg=k)


def test_ghost_full_rows_f32_equals_fused_batch_norm():
    args = _ghost_inputs(2)
    got = _port_norm(GhostBatchNorm(12, torch.float32, 0, torch.float32),
                     *args)
    want = _port_norm(FusedBatchNorm(12, torch.float32), *args)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ghost_statistics_read_a_row_prefix(monkeypatch, dtype):
    """K1 (its plain version here) reads the first stats_rows images as a
    prefix of the (R, C) view: no copy of a bf16 activation, and only
    rows·H·W rows; K2 reads all R rows. bf16 statistics take the rounding
    variant."""
    seen = []
    stats, corr = bn._stats, bn._corr

    def record(name, fn):
        def wrapped(*a):
            seen.append((name, a[-1] if name == "stats" and len(a) == 2
                         else False, a[0].shape, a[0].data_ptr()))
            return fn(*a)
        return wrapped
    monkeypatch.setattr(bn, "_stats", record("stats", stats))
    monkeypatch.setattr(bn, "_corr", record("corr", corr))
    x = torch.randn(6, 12, 5, 4).to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last).requires_grad_(True)
    m = GhostBatchNorm(12, torch.bfloat16, 2, getattr(torch, dtype))
    m.train()(x).float().sum().backward()
    (_, rounded, shape, ptr), (name, _, cshape, _) = seen
    assert shape == (2 * 5 * 4, 12) and ptr == x.data_ptr()
    assert rounded == (dtype == "bfloat16")
    assert name == "corr" and cshape == (6 * 5 * 4, 12)


# ----------------------------------------------------------------------
# the flax route
# ----------------------------------------------------------------------
def test_flax_route_updates_with_the_biased_variance(monkeypatch):
    """Two values a channel (R = 2): nn.BatchNorm2d would move the running
    variance with 2× the biased one; the flax route takes the biased one,
    with flax's momentum, and runs no kernel of this repo."""
    for name in ("_stats", "_corr"):
        monkeypatch.setattr(bn, name, lambda *a: pytest.fail("K1/K2 ran"))
    x = torch.tensor([[[[1.0]], [[4.0]]], [[[3.0]], [[-2.0]]]])  # (2,2,1,1)
    m = FlaxBatchNorm(2, torch.float32)
    y = m.train()(x.contiguous(memory_format=torch.channels_last))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(m.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(m.running_mean, 0.1 * x.mean(dim=(0, 2, 3)))
    ref = (x - x.mean(dim=(0, 2, 3), keepdim=True)) * torch.rsqrt(
        var.view(1, -1, 1, 1) + 1e-5)
    torch.testing.assert_close(y, ref)
    y.sum().backward()
