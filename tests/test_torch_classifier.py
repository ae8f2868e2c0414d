"""The port's classifier slice against the JAX package on the CPU:
multi_level_ce, device_scale, the learning-rate schedule, and two whole
train steps (losses, step-1 gradients, running statistics) of a
bn_impl='pallas' float32 ResNet-18 trainer started from the same weights;
plus the port's device rule, checkpoint payload and entry points."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from learning_embeddings_tpu.hierarchy import toy_labelmap as jax_toy
from learning_embeddings_tpu.losses.classification import (
    make_multi_level_ce as jax_multi_level_ce)
from learning_embeddings_tpu.ops.image import device_scale as jax_scale
from learning_embeddings_tpu.train.classifier import (
    ClassifierConfig as JaxConfig, ClassifierTrainer as JaxTrainer)
from learning_embeddings_tpu_torch import entry as port_entry
from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
from learning_embeddings_tpu_torch.losses import make_multi_level_ce
from learning_embeddings_tpu_torch.models import state_dict_from_jax
from learning_embeddings_tpu_torch.ops.image import device_scale
from learning_embeddings_tpu_torch.train.classifier import (
    ClassifierConfig, ClassifierTrainer, make_criterion)

torch.set_num_threads(2)

B, SIZE, LR = 8, 32, 1e-3
STAGES18 = (2, 2, 2, 2)


def _batch(lm, seed=0):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)
    ll = lm.leaf_paths()[rng.randint(0, lm.levels[-1], B)].astype(np.int32)
    mh = np.zeros((B, lm.n_classes), np.float32)
    mh[np.arange(B)[:, None], ll + np.asarray(lm.level_start)] = 1.0
    return imgs, ll, mh


@pytest.mark.parametrize("weighted", [False, True])
def test_multi_level_ce_matches_jax(weighted):
    lm, jlm = toy_labelmap(3, 3), jax_toy(3, 3)
    rng = np.random.RandomState(1)
    logits = rng.randn(6, lm.n_classes).astype(np.float32)
    ll = lm.leaf_paths()[rng.randint(0, lm.levels[-1], 6)].astype(np.int64)
    lw = [0.5, 1.0, 2.0] if weighted else None
    cw = (0.5 + rng.rand(lm.n_classes)).astype(np.float32) if weighted \
        else None
    got = make_multi_level_ce(lm, lw, cw)(torch.from_numpy(logits),
                                          torch.from_numpy(ll))
    ref = jax_multi_level_ce(jlm, lw, cw)(jnp.asarray(logits),
                                          jnp.asarray(ll.astype(np.int32)))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_class_weights_follow_the_logits_device():
    """make_multi_level_ce and make_criterion put no class weight on a
    fixed device: on the first call they move to the logits' (the meta
    device stands in for a card here: a CPU weight indexed by meta labels
    raises)."""
    lm = toy_labelmap(3, 3)
    cw = np.linspace(0.5, 1.5, lm.n_classes).astype(np.float32)
    logits = torch.zeros((4, lm.n_classes), device="meta")
    ll = torch.zeros((4, lm.n_levels), dtype=torch.int64, device="meta")
    loss = make_multi_level_ce(lm, None, cw)(logits, ll)
    assert loss.device.type == "meta" and loss.shape == ()
    criterion = make_criterion(lm, ClassifierConfig(
        criterion="multi_level_ce", class_weights=cw, device="cpu"))
    loss, scores = criterion(logits, ll, None)
    assert loss.device.type == "meta" and scores is logits
    # and still on the CPU afterwards
    cpu = make_multi_level_ce(lm, None, cw)
    cpu(logits, ll)
    assert np.isfinite(float(cpu(torch.zeros((4, lm.n_classes)),
                                 torch.zeros((4, 3), dtype=torch.int64))))


def test_device_scale_is_bit_identical():
    imgs = np.arange(256, dtype=np.uint8).reshape(4, 8, 8, 1)
    got = device_scale(torch.from_numpy(imgs)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_scale(
        jnp.asarray(imgs))))
    np.testing.assert_array_equal(got, imgs.astype(np.float32) / 255.0)
    f = torch.rand(2, 3)
    assert device_scale(f) is f


@pytest.fixture(scope="module")
def jax_run():
    """One JAX trainer: its initial weights, step-1 gradients, and the
    losses and running statistics of two steps."""
    lm = jax_toy(3, 3)
    cfg = JaxConfig(backbone="resnet18", criterion="multi_level_ce", lr=LR,
                    image_size=SIZE, batch_size=B, seed=0,
                    dtype=jnp.float32, bn_impl="pallas", donate=False,
                    lr_steps=(1, 3), steps_per_epoch=2)
    tr = JaxTrainer(lm, cfg)
    batch = tr.put_batch(*_batch(lm))
    st0 = tr.state

    def loss_fn(params):
        raw, _ = tr.model.apply(
            {"params": params, "batch_stats": st0.batch_stats},
            jax_scale(batch[0]), train=True, mutable=["batch_stats"])
        return tr.criterion(raw, batch[1], batch[2])[0]

    grads = jax.device_get(jax.jit(jax.grad(loss_fn))(st0.params))
    st1, l1 = tr.train_step(st0, *batch)
    _, l2 = tr.train_step(st1, *batch)
    return {"params0": jax.device_get(st0.params),
            "stats0": jax.device_get(st0.batch_stats),
            "stats1": jax.device_get(st1.batch_stats),
            "grads": grads, "losses": (float(l1), float(l2)),
            "lr": [float(tr.lr_schedule(k)) for k in range(9)]}


@pytest.fixture(scope="module")
def port_run(jax_run):
    lm = toy_labelmap(3, 3)
    cfg = ClassifierConfig(backbone="resnet18", criterion="multi_level_ce",
                           lr=LR, image_size=SIZE, batch_size=B, seed=0,
                           dtype=torch.float32, device="cpu",
                           lr_steps=(1, 3), steps_per_epoch=2)
    tr = ClassifierTrainer(lm, cfg)
    tr.model.load_state_dict(state_dict_from_jax(
        jax_run["params0"], jax_run["stats0"], STAGES18), strict=True)
    batch = tr.put_batch(*_batch(lm))
    st1, l1 = tr.train_step(tr.state, *batch)
    grads = {k: p.grad.clone() for k, p in tr.model.named_parameters()}
    stats1 = {k: v.clone() for k, v in tr.model.named_buffers()}
    _, l2 = tr.train_step(st1, *batch)
    return {"trainer": tr, "grads": grads, "stats1": stats1,
            "losses": (float(l1), float(l2))}


def test_two_train_steps_losses_match_jax(jax_run, port_run):
    (j1, j2), (p1, p2) = jax_run["losses"], port_run["losses"]
    assert abs(p1 - j1) < 1e-3
    # the second step runs after an Adam update from the first one
    assert abs(p2 - j2) < 2e-3
    assert port_run["trainer"].state.step == 2


def test_step1_gradients_match_jax(jax_run, port_run):
    want = state_dict_from_jax(jax_run["grads"], jax_run["stats0"], STAGES18)
    have = port_run["grads"]
    assert set(have) <= set(want) and len(have) == 62
    for k, g in have.items():
        # a weight gradient sums terms of both signs over the batch, so an
        # entry near 0 carries the rounding of the large ones: against a
        # float64 evaluation the JAX f32 gradients are off by up to 6e-5 of
        # their tensor's largest entry (the port's by less), hence an atol
        # scaled to that entry on top of the 1e-5 floor
        ref = want[k].numpy()
        np.testing.assert_allclose(
            g.numpy(), ref, rtol=1e-3,
            atol=max(1e-5, 1e-4 * float(np.abs(ref).max())), err_msg=k)


def test_step1_running_stats_match_jax(jax_run, port_run):
    want = state_dict_from_jax(jax_run["params0"], jax_run["stats1"],
                               STAGES18)
    have = port_run["stats1"]
    assert len(have) == 40
    for k, v in have.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_lr_schedule_matches_jax(jax_run, port_run):
    tr = port_run["trainer"]
    got = [tr.lr_schedule(k) for k in range(9)]
    np.testing.assert_allclose(got, jax_run["lr"], rtol=1e-6)
    # the optimizer really runs at the schedule: two updates done
    assert tr.state.optimizer.param_groups[0]["lr"] == pytest.approx(got[2])


def test_checkpoint_payload_round_trip(port_run):
    tr = port_run["trainer"]
    lm = toy_labelmap(3, 3)
    fresh = ClassifierTrainer(lm, ClassifierConfig(**{
        **tr.cfg.__dict__, "seed": 1}))
    fresh.restore_payload(tr.checkpoint_payload())
    batch = tr.put_batch(*_batch(lm, seed=2))
    _, la = tr.train_step(tr.state, *batch)
    _, lb = fresh.train_step(fresh.state, *batch)
    assert float(la) == float(lb)
    assert fresh.state.step == tr.state.step


def test_freeze_bn_keeps_running_stats(port_run):
    tr = port_run["trainer"]
    lm = toy_labelmap(3, 3)
    frozen = ClassifierTrainer(lm, ClassifierConfig(**{
        **tr.cfg.__dict__, "freeze_bn": True}))
    before = {k: v.clone() for k, v in frozen.model.named_buffers()}
    _, loss = frozen.train_step(frozen.state, *frozen.put_batch(*_batch(lm)))
    assert np.isfinite(float(loss))
    for k, v in frozen.model.named_buffers():
        assert torch.equal(v, before[k]), k


def test_cuda_is_never_replaced_by_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ClassifierTrainer(toy_labelmap(2, 2), ClassifierConfig(
            backbone="resnet18", image_size=32, device="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_entry.entry()


@pytest.mark.parametrize("bad", [dict(bn_impl="cudnn"),
                                 dict(backbone="vgg16")])
def test_unported_options_raise(bad):
    # bn_impl='flax' and vgg11_bn are ported; a route or backbone that
    # neither package has raises
    with pytest.raises(ValueError, match="bn_impl|backbone"):
        ClassifierTrainer(toy_labelmap(2, 2), ClassifierConfig(**{
            "backbone": "resnet18", "image_size": 32, "device": "cpu",
            **bad}))


def test_entry_forward_on_butterfly200(monkeypatch):
    monkeypatch.delenv("ETHEC_SPLITS_DIR", raising=False)
    fn, args = port_entry.entry(device="cpu", batch_size=1, image_size=64,
                                dtype=torch.float32)
    out = fn(*args)
    assert out.shape == (1, 5 + 23 + 116 + 200)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_ethec_labelmap_from_split_checks_its_levels(tmp_path, monkeypatch):
    recs = {str(i): {"family": f"f{i % 2}", "subfamily": f"s{i % 2}",
                     "genus": f"g{i}", "specific_epithet": f"e{i}"}
            for i in range(6)}
    (tmp_path / "val.json").write_text(json.dumps(recs))
    monkeypatch.setenv("ETHEC_SPLITS_DIR", str(tmp_path))
    with pytest.raises(ValueError, match="expected"):
        port_entry.ethec_labelmap()
