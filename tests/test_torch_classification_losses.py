"""The port's classification criteria (``losses/classification.py``,
``train/classifier.py::make_criterion``) and heads (``models/heads.py``)
against the JAX package on the CPU, on the same numpy-seeded inputs.

Tolerances: losses rtol 1e-5 (float32 on both sides); the scores each
criterion hands the evaluator rtol 1e-5, atol 1e-6; the gradients of
``hsoftmax`` and ``multi_level_ce`` with respect to the logits rtol 1e-4,
atol 1e-6; the heads' forward outputs (float32 ResNet-18 at 24², eval
mode, weights carried over with ``state_dict_from_jax``) rtol 1e-4, atol
1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from learning_embeddings_tpu.hierarchy import toy_labelmap as jax_toy
from learning_embeddings_tpu.losses import classification as jc
from learning_embeddings_tpu.models.heads import HierarchicalCNN as JaxCNN
from learning_embeddings_tpu.train.classifier import (
    ClassifierConfig as JaxConfig, make_criterion as jax_make_criterion)
from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
from learning_embeddings_tpu_torch.losses import classification as tc
from learning_embeddings_tpu_torch.models import (HierarchicalCNN,
                                                  state_dict_from_jax)
from learning_embeddings_tpu_torch.train.classifier import (
    CRITERIA, CRITERION_TO_HEAD, ClassifierConfig, make_criterion)

torch.set_num_threads(2)

B = 12


def _inputs(lm, seed=0, width=None, scale=3.0):
    rng = np.random.RandomState(seed)
    logits = (scale * rng.randn(B, width or lm.n_classes)).astype(np.float32)
    ll = lm.leaf_paths()[rng.randint(0, lm.levels[-1], B)].astype(np.int64)
    mh = np.zeros((B, lm.n_classes), np.float32)
    mh[np.arange(B)[:, None], ll + np.asarray(lm.level_start)] = 1.0
    return logits, ll, mh


def _weights(lm, seed=1):
    rng = np.random.RandomState(seed)
    return ([0.5, 1.0, 2.0][:lm.n_levels],
            (0.5 + rng.rand(lm.n_classes)).astype(np.float32))


@pytest.mark.parametrize("weighted", [False, True])
def test_last_level_ce_matches_jax(weighted):
    lm, jlm = toy_labelmap(3, 3), jax_toy(3, 3)
    logits, ll, _ = _inputs(lm, width=lm.levels[-1])
    lw, cw = _weights(lm) if weighted else (None, None)
    probs, loss = tc.make_last_level_ce(lm, lw, cw)(
        torch.from_numpy(logits), torch.from_numpy(ll))
    jprobs, jloss = jc.make_last_level_ce(jlm, lw, cw)(
        jnp.asarray(logits), jnp.asarray(ll.astype(np.int32)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-5,
                               atol=1e-6)
    # a parent's probability is the sum of its children's
    np.testing.assert_allclose(probs[:, :lm.levels[0]].sum(1).numpy(), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_masked_ce_matches_jax(weighted):
    lm, jlm = toy_labelmap(3, 3), jax_toy(3, 3)
    logits, ll, _ = _inputs(lm, seed=2)
    lw = _weights(lm)[0] if weighted else None
    out, loss = tc.make_masked_ce(lm, lw)(torch.from_numpy(logits),
                                          torch.from_numpy(ll))
    jout, jloss = jc.make_masked_ce(jlm, lw)(
        jnp.asarray(logits), jnp.asarray(ll.astype(np.int32)))
    # the batch SUM, as the reference's mean over a one-element tensor
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(loss) > 1.0
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert (out.numpy() == -1e8).any()


@pytest.mark.parametrize("weighted", [False, True])
def test_multi_label_soft_margin_matches_jax(weighted):
    lm = toy_labelmap(3, 3)
    logits, _, mh = _inputs(lm, seed=3)
    w = _weights(lm)[1] if weighted else None
    got = tc.multi_label_soft_margin(
        torch.from_numpy(logits), torch.from_numpy(mh),
        None if w is None else torch.from_numpy(w))
    ref = jc.multi_label_soft_margin(jnp.asarray(logits), jnp.asarray(mh),
                                     None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    if not weighted:   # and torch's own MultiLabelSoftMarginLoss
        want = torch.nn.MultiLabelSoftMarginLoss()(torch.from_numpy(logits),
                                                   torch.from_numpy(mh))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_hierarchical_softmax_matches_jax():
    lm, jlm = toy_labelmap(3, 3), jax_toy(3, 3)
    logits, ll, _ = _inputs(lm, seed=4)
    all_lp, leaf_lp = tc.make_hierarchical_softmax(lm)(
        torch.from_numpy(logits))
    jall, jleaf = jc.make_hierarchical_softmax(jlm)(jnp.asarray(logits))
    np.testing.assert_allclose(all_lp.numpy(), np.asarray(jall), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(leaf_lp.numpy(), np.asarray(jleaf),
                               rtol=1e-5, atol=1e-6)
    # each level is a distribution
    for l in range(lm.n_levels):
        a, b = int(lm.level_start[l]), int(lm.level_stop[l])
        np.testing.assert_allclose(all_lp[:, a:b].exp().sum(1).numpy(), 1.0,
                                   rtol=1e-5)
    nll = tc.hierarchical_softmax_nll(leaf_lp, torch.from_numpy(ll))
    jnll = jc.hierarchical_softmax_nll(jleaf, jnp.asarray(ll.astype(np.int32)))
    np.testing.assert_allclose(float(nll), float(jnll), rtol=1e-5)


@pytest.mark.parametrize("criterion", ["hsoftmax", "multi_level_ce"])
def test_gradients_match_jax(criterion):
    lm, jlm = toy_labelmap(3, 3), jax_toy(3, 3)
    logits, ll, mh = _inputs(lm, seed=5)
    lw, cw = _weights(lm)
    kw = dict(criterion=criterion, level_weights=lw,
              class_weights=cw if criterion == "multi_level_ce" else None)
    f = make_criterion(lm, ClassifierConfig(device="cpu", **kw))
    x = torch.from_numpy(logits).requires_grad_(True)
    f(x, torch.from_numpy(ll), torch.from_numpy(mh))[0].backward()
    jf = jax_make_criterion(jlm, JaxConfig(**kw))
    jg = jax.grad(lambda z: jf(z, jnp.asarray(ll.astype(np.int32)),
                               jnp.asarray(mh))[0])(jnp.asarray(logits))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("criterion", CRITERIA)
def test_make_criterion_matches_jax(criterion):
    lm, jlm = toy_labelmap(3, 3), jax_toy(3, 3)
    head = CRITERION_TO_HEAD[criterion]
    logits, ll, mh = _inputs(
        lm, seed=6, width=lm.levels[-1] if head == "leaf" else None)
    lw, cw = _weights(lm)
    kw = dict(criterion=criterion, level_weights=lw, class_weights=cw)
    loss, scores = make_criterion(lm, ClassifierConfig(device="cpu", **kw))(
        torch.from_numpy(logits), torch.from_numpy(ll), torch.from_numpy(mh))
    jloss, jscores = jax_make_criterion(jlm, JaxConfig(**kw))(
        jnp.asarray(logits), jnp.asarray(ll.astype(np.int32)),
        jnp.asarray(mh))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=1e-5, atol=1e-6)
    assert scores.shape == (B, lm.n_classes)


# ----------------------------------------------------------------------
# heads
# ----------------------------------------------------------------------
SIZE = 24


@pytest.mark.parametrize("head", ["multi_head", "leaf", "hsoftmax",
                                  "bottleneck2d"])
def test_heads_forward_matches_jax(head):
    lm = toy_labelmap(2, 3)
    levels = tuple(lm.levels)
    rng = np.random.RandomState(7)
    images = rng.rand(3, SIZE, SIZE, 3).astype(np.float32)
    jmodel = JaxCNN(backbone="resnet18", levels=levels, head=head,
                    dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(images),
                            train=False)
    # non-trivial running statistics, so eval-mode BN is exercised
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.1 * rng.rand(*v.shape).astype(
            np.float32), jax.device_get(variables["batch_stats"]))
    variables = {"params": variables["params"], "batch_stats": stats}
    model = HierarchicalCNN("resnet18", levels, head=head,
                            dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(
        jax.device_get(variables["params"]), stats, (2, 2, 2, 2)),
        strict=True)
    model.eval()
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = model(x)
    want = jmodel.apply(variables, jnp.asarray(images), train=False)
    width = levels[-1] if head == "leaf" else sum(levels)
    assert got.shape == (3, width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    if head == "bottleneck2d":
        with torch.no_grad():
            scores, z = model(x, capture_bottleneck=True)
        jscores, jz = jmodel.apply(variables, jnp.asarray(images),
                                   train=False, capture_bottleneck=True)
        assert z.shape == (3, 2)
        assert model.level_fc0.bias is None
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                                   rtol=1e-4, atol=1e-5)


def test_unknown_head_raises():
    with pytest.raises(ValueError, match="unknown head"):
        HierarchicalCNN("resnet18", (2, 4), head="wide")
