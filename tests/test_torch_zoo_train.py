"""The zoo's train-step options against the JAX package on the CPU
(float32): ``remat`` (one classifier step with it leaves the same
parameters and running statistics as one without, and recomputes the
block BatchNorms' statistics only), the ``bn_impl='flax'`` route (one
step against JAX's flax-BatchNorm step at batch 2 and 64², where the last
stage's BatchNorms see R = 8 values a channel and the unbiased variance
would be 8/7 of the biased one), the route precedence, and
``JointCNNTrainer`` with ``remat`` and with bf16 BatchNorm statistics
against the JAX trainer.

Tolerances:
* remat against no remat: the same operations on the same values, so the
  parameters and running statistics are equal bit for bit.
* flax route: loss rtol 1e-5; after one SGD step (lr 0.1) every parameter
  within 1e-5 and the running statistics within rtol 1e-4, atol 1e-5 (the
  library's two-pass variance against flax's E[x²] − E[x]², sums in
  another order).
* joint step with remat: ``test_torch_joint_cnn.check_step``'s, which it
  meets as the plain step does; with bf16 statistics the bf16 tolerances
  of ``test_joint_bf16_stats_step_matches_jax``.
"""

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
from learning_embeddings_tpu_torch.ops.bn import (FlaxBatchNorm,
                                                  FusedBatchNorm,
                                                  GhostBatchNorm)
from learning_embeddings_tpu_torch.train.classifier import (
    ClassifierConfig, ClassifierTrainer)
from test_torch_joint_cnn import (LR_IMAGES, check_step,  # noqa: F401
                                  make_pair, run_step, setup)

torch.set_num_threads(2)

STAGES18 = (2, 2, 2, 2)


def _batch(lm, b, size, seed=0):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)
    ll = lm.leaf_paths()[rng.randint(0, lm.levels[-1], b)].astype(np.int32)
    mh = np.zeros((b, lm.n_classes), np.float32)
    mh[np.arange(b)[:, None], ll + np.asarray(lm.level_start)] = 1.0
    return imgs, ll, mh


def _count_reductions(monkeypatch):
    calls = {"stats": 0, "corr": 0}
    stats, corr = bn._stats, bn._corr

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped
    monkeypatch.setattr(bn, "_stats", count("stats", stats))
    monkeypatch.setattr(bn, "_corr", count("corr", corr))
    return calls


def test_remat_step_equals_the_plain_step(monkeypatch):
    lm = toy_labelmap(2, 3)
    batch = _batch(lm, 6, 32)
    out = {}
    for remat in (False, True):
        tr = ClassifierTrainer(lm, ClassifierConfig(
            backbone="resnet18", image_size=32, batch_size=6, lr=1e-3,
            dtype=torch.float32, device="cpu", remat=remat))
        calls = _count_reductions(monkeypatch)
        _, loss = tr.train_step(tr.state, *tr.put_batch(*batch))
        out[remat] = (float(loss), dict(calls),
                      {k: v.detach().clone()
                       for k, v in tr.model.state_dict().items()})
    # 20 BN layers; with remat the 19 inside residual blocks run their
    # forward (K1) again in the backward pass, the stem's does not
    assert out[False][1] == {"stats": 20, "corr": 20}
    assert out[True][1] == {"stats": 20 + 19, "corr": 20}
    assert out[True][0] == out[False][0]
    for k, v in out[False][2].items():
        assert torch.equal(out[True][2][k], v), k


def test_remat_is_off_outside_training():
    lm = toy_labelmap(2, 3)
    tr = ClassifierTrainer(lm, ClassifierConfig(
        backbone="resnet18", image_size=32, batch_size=6, dtype=torch.float32,
        device="cpu", remat=True))
    imgs, ll, mh = tr.put_batch(*_batch(lm, 6, 32))
    loss, scores = tr.eval_step(tr.state, imgs, ll, mh)
    assert scores.shape == (6, lm.n_classes) and torch.isfinite(loss)


@pytest.mark.parametrize("kw,cls", [
    (dict(), FusedBatchNorm), (dict(bn_impl="flax"), FlaxBatchNorm),
    (dict(bn_stats_rows=4), GhostBatchNorm),
    (dict(bn_impl="flax", bn_stats_dtype="bfloat16"), GhostBatchNorm)],
    ids=["pallas", "flax", "ghost", "bf16_over_flax"])
def test_bn_route_precedence(kw, cls):
    tr = ClassifierTrainer(toy_labelmap(2, 2), ClassifierConfig(
        backbone="vgg11_bn", image_size=32, device="cpu", **kw))
    norms = [m for m in tr.model.modules() if isinstance(m, bn.BatchNormBase)]
    assert len(norms) == 8 and all(type(m) is cls for m in norms)
    if cls is GhostBatchNorm:
        assert norms[0].stats_rows == (kw.get("bn_stats_rows") or -1)
        assert norms[0].stats_dtype == getattr(
            torch, kw.get("bn_stats_dtype", "float32"))


def test_flax_route_step_matches_jax(monkeypatch):
    B, SIZE = 2, 64
    jlm, lm = jax_toy(2, 3), toy_labelmap(2, 3)
    common = dict(backbone="resnet18", image_size=SIZE, batch_size=B, seed=0,
                  optimizer="sgd", lr=0.1, bn_impl="flax")
    jtr = JaxTrainer(jlm, JaxConfig(dtype=jnp.float32, donate=False,
                                    **common))
    tr = ClassifierTrainer(lm, ClassifierConfig(dtype=torch.float32,
                                                device="cpu", **common))
    tr.model.load_state_dict(state_dict_from_jax(
        jax.device_get(jtr.state.params),
        jax.device_get(jtr.state.batch_stats), STAGES18), strict=True)
    for name in ("_stats", "_corr"):
        monkeypatch.setattr(bn, name, lambda *a: pytest.fail("K1/K2 ran"))
    batch = _batch(lm, B, SIZE)
    jstate, jloss = jtr.train_step(jtr.state, *batch)
    _, loss = tr.train_step(tr.state, *tr.put_batch(*batch))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want = state_dict_from_jax(jax.device_get(jstate.params),
                               jax.device_get(jstate.batch_stats), STAGES18)
    have = tr.model.state_dict()
    for k, v in have.items():
        w = want[k].numpy()
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), w, rtol=0, atol=1e-5,
                                       err_msg=k)
    # layer4's BatchNorms see R = 8 values a channel: the unbiased variance
    # (nn.BatchNorm2d's update) would put 0.1·var/7 more into running_var,
    # far outside the tolerance above
    k = "trunk.layer4.1.bn2.running_var"
    biased = (want[k].numpy() - 0.9) / 0.1
    assert np.abs(0.9 + 0.1 * biased * 8 / 7 - have[k].numpy()).max() > 1e-3


def test_joint_remat_step_matches_jax(setup):  # noqa: F811
    jt, pt = make_pair(setup, energy="order", remat=True)
    assert pt.featcnn.trunk.remat
    out_j, out_p, _, want, table = run_step(jt, pt, setup["batch"])
    check_step(out_j, out_p, want, table, pt)


def test_joint_bf16_stats_step_matches_jax(setup):  # noqa: F811
    """bf16 statistics round each channel's Σx/R and Σx²/R to bf16 on both
    sides from f32 sums taken in another order; where one lands on the
    other side of a bf16 rounding boundary the two differ by a bf16 step
    (measured: first one channel of layer3.0's downsample BN, everything
    before it equal), and every layer after it carries that. So the step
    is held to bf16 tolerances: the loss within 3e-2 (measured 1.1e-2),
    the energies within 5e-2 of their largest (measured 2.1e-2), the
    running statistics within 2e-2 (measured 6.3e-3), the label table to
    rounding, and each trained entry of the tower within one Adam step's
    sign flip (2·lr)."""
    jt, pt = make_pair(setup, energy="order", bn_stats_dtype="bfloat16")
    norms = [m for m in pt.featcnn.modules()
             if isinstance(m, bn.BatchNormBase)]
    assert len(norms) == 20 and all(
        type(m) is GhostBatchNorm and m.stats_rows == -1
        and m.stats_dtype == torch.bfloat16 for m in norms)
    out_j, out_p, _, want, table = run_step(jt, pt, setup["batch"])
    (lj, epj, enj), (lp, epp, enp) = out_j, out_p
    assert float(lp) == pytest.approx(float(lj), rel=3e-2)
    for a, b in ((epp, epj), (enp, enj)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=5e-2 * np.abs(b).max())
    np.testing.assert_allclose(pt.embedder.embedding.detach().numpy(), table,
                               rtol=0, atol=1e-6)
    for k, v in pt.featcnn.state_dict().items():
        tol = 2e-2 if "running" in k else 2 * LR_IMAGES + 1e-6
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=tol, err_msg=k)


def test_s2d_load_backbone_state_dict_matches_jax(tmp_path):
    """A torchvision-named 7×7 ResNet-18 file loaded into an s2d trainer:
    conv1 goes through s2d_stem_kernel (JAX ``train/classifier.py``
    305-315), the rest loads as it is, and both packages' s2d trainers
    then hold the same trunk and score the same logits (f32, rtol 1e-4,
    atol 1e-5: conv sums in another order)."""
    from learning_embeddings_tpu_torch.models.resnet import s2d_stem_kernel

    lm, jlm = toy_labelmap(2, 3), jax_toy(2, 3)
    source = ClassifierTrainer(lm, ClassifierConfig(
        backbone="resnet18", image_size=32, dtype=torch.float32,
        device="cpu", seed=5))
    sd = {k: v.clone() for k, v in source.model.trunk.state_dict().items()}
    path = str(tmp_path / "resnet18.pth")
    torch.save(sd, path)
    common = dict(backbone="resnet18", image_size=32, batch_size=6, seed=0,
                  stem="s2d")
    jtr = JaxTrainer(jlm, JaxConfig(dtype=jnp.float32, bn_impl="pallas",
                                    donate=False, **common))
    tr = ClassifierTrainer(lm, ClassifierConfig(dtype=torch.float32,
                                                device="cpu", **common))
    tr.load_backbone_state_dict(path)
    jtr.load_backbone_state_dict(path)
    have = tr.model.trunk.state_dict()
    assert torch.equal(have["conv1.weight"],
                       s2d_stem_kernel(sd["conv1.weight"]))
    want = state_dict_from_jax(jax.device_get(jtr.state.params),
                               jax.device_get(jtr.state.batch_stats),
                               STAGES18)
    for k, v in have.items():
        torch.testing.assert_close(v, want["trunk." + k], rtol=0, atol=0)
    tr.model.fc.load_state_dict({"weight": want["fc.weight"],
                                 "bias": want["fc.bias"]})
    batch = _batch(lm, 6, 32)
    _, scores = tr.eval_step(tr.state, *tr.put_batch(*batch))
    _, jscores = jtr.eval_step(jtr.state, *jtr.put_batch(*batch))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=1e-4, atol=1e-5)
