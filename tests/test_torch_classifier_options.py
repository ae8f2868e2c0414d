"""The classifier trainer's options (``train/classifier.py``) against the
JAX package on the CPU: ``freeze_trunk``, ``grad_accum``, grayscale input,
``load_backbone_state_dict`` and the config's defaults. Both sides run a
float32 ResNet-18 with the fused-reduction BatchNorm (the JAX side's
``bn_impl='pallas'`` as its own tests run it here), started from the same
weights through ``state_dict_from_jax``.

Tolerances:
* freeze_trunk: the trunk's parameters bit-unchanged; no BN backward
  reduction runs (the trunk takes no gradient).
* grad_accum=2 against ``optax.MultiSteps``: losses rtol 1e-4; after the
  one update, parameters atol 1e-5 (SGD, so the update is the averaged
  gradient times the lr) and running statistics atol 1e-5; the lr
  schedule (boundaries at steps_per_epoch // grad_accum) rtol 1e-6.
* grayscale: the loss of one train step rtol 1e-4.
* load_backbone_state_dict from a torchvision-named .pth written from the
  port's trunk: the port's trunk equals the file exactly; the JAX trunk
  loaded from the same file (its ``torch_import``) gives forward outputs
  within rtol 1e-4, atol 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from learning_embeddings_tpu.hierarchy import toy_labelmap as jax_toy
from learning_embeddings_tpu.train.classifier import (
    ClassifierConfig as JaxConfig, ClassifierTrainer as JaxTrainer)
from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
from learning_embeddings_tpu_torch.models import state_dict_from_jax
from learning_embeddings_tpu_torch.ops import bn
from learning_embeddings_tpu_torch.train.classifier import (
    ClassifierConfig, ClassifierTrainer)

torch.set_num_threads(2)

B, SIZE = 6, 32
STAGES18 = (2, 2, 2, 2)


def _batch(lm, seed=0, channels=3):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (B, SIZE, SIZE, channels)).astype(np.uint8)
    ll = lm.leaf_paths()[rng.randint(0, lm.levels[-1], B)].astype(np.int32)
    mh = np.zeros((B, lm.n_classes), np.float32)
    mh[np.arange(B)[:, None], ll + np.asarray(lm.level_start)] = 1.0
    return imgs, ll, mh


def _pair(jax_kw, port_kw=None, grayscale=False):
    """A JAX trainer and a port trainer holding the JAX trainer's initial
    weights."""
    jlm, lm = jax_toy(2, 3), toy_labelmap(2, 3)
    common = dict(backbone="resnet18", image_size=SIZE, batch_size=B,
                  seed=0, **jax_kw)
    jtr = JaxTrainer(jlm, JaxConfig(dtype=jnp.float32, bn_impl="pallas",
                                    donate=False, **common),
                     grayscale=grayscale)
    tr = ClassifierTrainer(lm, ClassifierConfig(
        dtype=torch.float32, device="cpu", **common, **(port_kw or {})),
        grayscale=grayscale)
    tr.model.load_state_dict(state_dict_from_jax(
        jax.device_get(jtr.state.params),
        jax.device_get(jtr.state.batch_stats), STAGES18), strict=True)
    return jtr, tr, lm


def _port_view(jtr):
    """The JAX trainer's parameters and running statistics under the
    port's names."""
    return state_dict_from_jax(jax.device_get(jtr.state.params),
                               jax.device_get(jtr.state.batch_stats),
                               STAGES18)


# ----------------------------------------------------------------------
# freeze_trunk
# ----------------------------------------------------------------------
def test_freeze_trunk_updates_only_the_head(monkeypatch):
    lm = toy_labelmap(2, 3)
    tr = ClassifierTrainer(lm, ClassifierConfig(
        backbone="resnet18", image_size=SIZE, batch_size=B, lr=1e-2,
        dtype=torch.float32, device="cpu", freeze_trunk=True))
    calls = {"stats": 0, "corr": 0}
    stats, corr = bn._stats, bn._corr

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped
    monkeypatch.setattr(bn, "_stats", count("stats", stats))
    monkeypatch.setattr(bn, "_corr", count("corr", corr))
    trunk0 = {k: v.clone() for k, v in tr.model.trunk.named_parameters()}
    buffers0 = {k: v.clone() for k, v in tr.model.trunk.named_buffers()}
    fc0 = tr.model.fc.weight.clone()
    for seed in (0, 1):
        _, loss = tr.train_step(tr.state, *tr.put_batch(*_batch(lm, seed)))
        assert np.isfinite(float(loss))
    for k, v in tr.model.trunk.named_parameters():
        assert torch.equal(v, trunk0[k]), k
        assert v.grad is None, k
    assert not torch.equal(tr.model.fc.weight, fc0)
    # the trunk's BN still runs in train mode: its statistics move, and
    # the forward reductions run, the backward ones do not
    assert not torch.equal(tr.model.trunk.bn1.running_mean,
                           buffers0["bn1.running_mean"])
    assert calls == {"stats": 2 * 20, "corr": 0}
    opt_params = {id(p) for g in tr.state.optimizer.param_groups
                  for p in g["params"]}
    assert opt_params == {id(p) for p in tr.model.fc.parameters()}


def test_freeze_trunk_step_matches_jax():
    jtr, tr, lm = _pair(dict(freeze_trunk=True, optimizer="sgd", lr=1e-2))
    batch = _batch(lm, 2)
    jtr.state, jl = jtr.train_step(jtr.state, *jtr.put_batch(*batch))
    _, loss = tr.train_step(tr.state, *tr.put_batch(*batch))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    want = _port_view(jtr)
    for k, v in tr.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


# ----------------------------------------------------------------------
# grad_accum
# ----------------------------------------------------------------------
def test_grad_accum_matches_optax_multisteps():
    kw = dict(grad_accum=2, optimizer="sgd", lr=1e-2, lr_steps=(1, 2),
              steps_per_epoch=8)
    jtr, tr, lm = _pair(kw)
    params0 = {k: v.clone() for k, v in tr.model.named_parameters()}
    losses, jlosses = [], []
    for i, seed in enumerate((3, 4)):
        batch = _batch(lm, seed)
        jtr.state, jl = jtr.train_step(jtr.state, *jtr.put_batch(*batch))
        _, loss = tr.train_step(tr.state, *tr.put_batch(*batch))
        jlosses.append(float(jl))
        losses.append(float(loss))
        if i == 0:   # the first micro-batch moves no parameter
            for k, v in tr.model.named_parameters():
                assert torch.equal(v, params0[k]), k
            assert tr.state.micro == 1
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert tr.state.micro == 0 and tr.state.step == 2
    want = _port_view(jtr)
    moved = 0
    for k, v in tr.model.state_dict().items():
        # parameters after the one update; running statistics after both
        # micro-batches
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
        moved += k in params0 and not torch.equal(v, params0[k])
    assert moved > 0
    # one update: the schedule is at its first step; boundaries every
    # steps_per_epoch // grad_accum = 4 updates
    np.testing.assert_allclose(
        [tr.lr_schedule(k) for k in range(12)],
        [float(jtr.lr_schedule(k)) for k in range(12)], rtol=1e-6)
    assert tr.lr_schedule(4) == pytest.approx(1e-3)
    assert tr.state.optimizer.param_groups[0]["lr"] == pytest.approx(
        tr.lr_schedule(1))


def test_grad_accum_checkpoint_between_micro_batches():
    """A checkpoint taken between two micro-batches carries the gradient
    accumulated so far: restored into a fresh trainer, the second
    micro-batch gives the same update."""
    lm = toy_labelmap(2, 3)
    cfg = ClassifierConfig(backbone="resnet18", image_size=SIZE,
                           batch_size=B, lr=1e-2, optimizer="sgd",
                           dtype=torch.float32, device="cpu", grad_accum=2)
    a = ClassifierTrainer(lm, cfg)
    b = ClassifierTrainer(lm, dataclasses.replace(cfg, seed=1))
    a.train_step(a.state, *a.put_batch(*_batch(lm, 5)))
    b.restore_payload(a.checkpoint_payload())
    assert b.state.micro == 1
    for tr in (a, b):
        tr.train_step(tr.state, *tr.put_batch(*_batch(lm, 6)))
    for (k, va), vb in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        assert torch.equal(va, vb), k


# ----------------------------------------------------------------------
# grayscale
# ----------------------------------------------------------------------
def test_grayscale_step_matches_jax():
    jtr, tr, lm = _pair(dict(lr=1e-3), grayscale=True)
    assert tr.model.trunk.conv1.weight.shape == (64, 1, 7, 7)
    batch = _batch(lm, 7, channels=1)
    jtr.state, jl = jtr.train_step(jtr.state, *jtr.put_batch(*batch))
    _, loss = tr.train_step(tr.state, *tr.put_batch(*batch))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    _, scores = tr.eval_step(tr.state, *tr.put_batch(*batch))
    assert scores.shape == (B, lm.n_classes)
    assert torch.isfinite(scores).all()


# ----------------------------------------------------------------------
# load_backbone_state_dict
# ----------------------------------------------------------------------
def _write_torchvision_file(path, trunk):
    """A torchvision-style ResNet state dict: the trunk's names plus a
    1000-way fc and num_batches_tracked counters."""
    sd = {k: v.clone() for k, v in trunk.state_dict().items()}
    for k in list(sd):
        if k.endswith("running_mean"):
            sd[k[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.tensor(7)
    sd["fc.weight"] = torch.randn(1000, trunk.feature_dim)
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, path)
    return sd


@pytest.mark.parametrize("grayscale", [False, True])
def test_load_backbone_state_dict_matches_jax(tmp_path, grayscale):
    lm = toy_labelmap(2, 3)
    source = ClassifierTrainer(lm, ClassifierConfig(
        backbone="resnet18", image_size=SIZE, dtype=torch.float32,
        device="cpu", seed=5))
    with torch.no_grad():      # non-trivial running statistics
        g = torch.Generator().manual_seed(0)
        for name, buf in source.model.trunk.named_buffers():
            buf.add_(0.2 * torch.rand(buf.shape, generator=g))
    path = str(tmp_path / "resnet18.pth")
    sd = _write_torchvision_file(path, source.model.trunk)

    jtr, tr, _ = _pair(dict(), grayscale=grayscale)
    conv1_fresh = tr.model.trunk.conv1.weight.clone()
    tr.load_backbone_state_dict(path)
    jtr.load_backbone_state_dict(path)
    for k, v in tr.model.trunk.state_dict().items():
        if grayscale and k == "conv1.weight":
            assert torch.equal(v, conv1_fresh)      # keeps its fresh init
        else:
            assert torch.equal(v, sd[k]), k
    # the JAX trunk loaded the same file (a grayscale conv1 kept the
    # fresh init both sides share); then the port takes JAX's head
    want = _port_view(jtr)
    for k, v in tr.model.trunk.state_dict().items():
        assert torch.equal(v, want["trunk." + k]), k
    tr.model.fc.load_state_dict({"weight": want["fc.weight"],
                                 "bias": want["fc.bias"]})
    batch = _batch(lm, 8, channels=1 if grayscale else 3)
    _, scores = tr.eval_step(tr.state, *tr.put_batch(*batch))
    _, jscores = jtr.eval_step(jtr.state, *jtr.put_batch(*batch))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------
# the config
# ----------------------------------------------------------------------
def test_config_defaults_equal_jax():
    """Every field both configs have defaults to the same value, except
    the BatchNorm route (the port defaults to the fused reductions) and
    the dtype's type; the JAX-only fields are the TPU/XLA ones and the
    unported partitioning option, which the CLI refuses."""
    def defaults(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}
    port, ref = defaults(ClassifierConfig), defaults(JaxConfig)
    assert set(port) - set(ref) == {"device"}
    assert set(ref) - set(port) == {"donate", "tp_patterns",
                                    "spatial_partition"}
    for k in sorted(set(port) & set(ref) - {"bn_impl", "dtype"}):
        assert port[k] == ref[k], k
    assert (port["bn_impl"], ref["bn_impl"]) == ("pallas", "flax")
    assert port["device"] == "cuda"


@pytest.mark.parametrize("bad", [dict(bn_impl="cudnn"),
                                 dict(optimizer="lamb"),
                                 dict(grad_accum=0)])
def test_unported_or_invalid_options_raise(bad):
    with pytest.raises(ValueError, match="bn_impl|optimizer|grad_accum"):
        ClassifierTrainer(toy_labelmap(2, 2), ClassifierConfig(
            backbone="resnet18", image_size=SIZE, device="cpu", **bad))
