"""The port's --use_CNN joint trainer against the JAX package on the CPU:
the FeatCNN tower and the label table with weights carried across, and
one JointCNNTrainer step (same seed, so the same host negatives) for each
energy and loss variant, with freeze_images and freeze_bn.

Sizes: ResNet-18 at 32², f32 tower, a toy taxonomy of 2/4/8 labels and 24
train images with distinct random pixels. Each step's batch holds 8
label→image edges and an image-level negative pass, so the tower sees 16
distinct images: with only a few distinct images a train-mode BN layer at
1×1 spatial size normalises a near-zero variance (Σx²/R − mean²), and
two summation orders then differ by far more than rounding."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from learning_embeddings_tpu.hierarchy import toy_labelmap as jax_toy
from learning_embeddings_tpu.losses.joint_sampling import (
    build_joint_graph as jax_build)
from learning_embeddings_tpu.models.embedder import FeatCNN as JaxFeatCNN
from learning_embeddings_tpu.models.embedder import (
    LabelEmbedder as JaxLabelEmbedder)
from learning_embeddings_tpu.train.joint_cnn import (
    JointCNNConfig as JaxConfig, JointCNNTrainer as JaxTrainer)
from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
from learning_embeddings_tpu_torch.losses.joint_sampling import (
    build_joint_graph)
from learning_embeddings_tpu_torch.models import (
    FeatCNN, LabelEmbedder, label_table_from_jax, state_dict_from_jax)
from learning_embeddings_tpu_torch.train.joint_cnn import (
    JointCNNConfig, JointCNNTrainer)

torch.set_num_threads(2)

STAGES18 = (2, 2, 2, 2)
SIZE = 32
LR_IMAGES = 1e-3


@pytest.fixture(scope="module")
def setup():
    lm, jlm = toy_labelmap(2, 3), jax_toy(2, 3)
    rng = np.random.RandomState(0)
    ll = lm.leaf_paths()[rng.randint(0, lm.levels[-1], 24)]
    graph, edges = build_joint_graph(lm, ll)
    jgraph, _ = jax_build(jlm, ll)
    bank = rng.randint(0, 256, (24, SIZE, SIZE, 3)).astype(np.uint8)

    def loader(rows):
        return bank[np.asarray(rows) % len(bank)]

    img_edges = edges[edges[:, 1] >= graph.n_labels]
    return dict(lm=lm, jlm=jlm, graph=graph, jgraph=jgraph, edges=edges,
                loader=loader, batch=img_edges[::3][:8])


def make_pair(setup, **kw):
    """A JAX trainer and a port trainer with the JAX one's weights."""
    common = dict(backbone="resnet18", embedding_dim=4, image_size=SIZE,
                  batch_size=8, neg_to_pos_ratio=4, alpha=0.5,
                  tower_dtype="float32", lr_labels=1e-2,
                  lr_images=LR_IMAGES, seed=0)
    common.update(kw)
    jt = JaxTrainer(setup["jlm"], setup["jgraph"], setup["edges"],
                    setup["loader"], JaxConfig(donate=False, **common))
    pt = JointCNNTrainer(setup["lm"], setup["graph"], setup["edges"],
                         setup["loader"],
                         JointCNNConfig(device="cpu", **common))
    params = jax.device_get(jt.params)
    pt.featcnn.load_state_dict(state_dict_from_jax(
        params["images"], jax.device_get(jt.batch_stats), STAGES18),
        strict=True)
    pt.embedder.load_state_dict(label_table_from_jax(params["labels"]))
    return jt, pt


def run_step(jt, pt, batch):
    """One step on each side from the same prepared batch; returns both
    outputs, the port tower's state before the step, and the JAX tower's
    state dict and label table after it."""
    before = {k: v.clone() for k, v in pt.featcnn.state_dict().items()}
    prep_j = jt.prepare_batch(batch[:, 0], batch[:, 1])
    prep_p = pt.prepare_batch(batch[:, 0], batch[:, 1])
    # the same host negatives, unique images, padding and slots
    for a, b in zip(prep_j, prep_p):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    out_j = jt.train_prepared(prep_j)
    out_p = pt.train_prepared(prep_p)
    params = jax.device_get(jt.params)
    want = state_dict_from_jax(params["images"],
                               jax.device_get(jt.batch_stats), STAGES18)
    table = np.asarray(params["labels"]["params"]["embedding"])
    return out_j, out_p, before, want, table


def check_step(out_j, out_p, want, table, pt, *, trunk_trains=True):
    (lj, epj, enj), (lp, epp, enp) = out_j, out_p
    assert np.isfinite(float(lp))
    # the f32 tower forward differs from the JAX one by ~2e-5 of its
    # largest output (summation orders in conv and BN); the energies and
    # the summed loss carry that
    assert float(lp) == pytest.approx(float(lj), rel=2e-5)
    for a, b in ((epp, epj), (enp, enj)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=2e-4 * max(1.0, np.abs(b).max()))
    # one Adam step moves each entry by lr·g/(|g| + eps) ≈ ±lr: the table
    # and fc get gradients far from 0 and agree to rounding
    np.testing.assert_allclose(pt.embedder.embedding.detach().numpy(), table,
                               rtol=0, atol=1e-6)
    have = pt.featcnn.state_dict()
    for k in ("fc.weight", "fc.bias"):
        np.testing.assert_allclose(have[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
    # BN running statistics: the same batch statistics to f32 rounding
    for k, v in have.items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    # trunk tensors: an entry whose gradient is within rounding of 0 may
    # take the other sign on the two sides and move by −lr instead of
    # +lr (2·lr apart); such entries must stay rare (measured: 69 of
    # 11.2 M), every other entry agrees to 1e-6
    n_far, n_all = 0, 0
    for k in [k for k in have if k.startswith("trunk.")
              and "running" not in k and "num_batches" not in k]:
        d = np.abs(have[k].numpy() - want[k].numpy())
        assert d.max() <= 2 * LR_IMAGES * trunk_trains + 1e-6, k
        n_far += int((d > 1e-6).sum())
        n_all += d.size
    assert n_far <= 1e-4 * n_all, (n_far, n_all)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_featcnn_forward_matches_jax(train):
    jf = JaxFeatCNN(backbone="resnet18", dim=4, mode="euc_cone", K=3.0,
                    dtype=jnp.float32)
    v = jf.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                train=False)
    pf = FeatCNN("resnet18", 4, mode="euc_cone", K=3.0, dtype=torch.float32)
    pf.load_state_dict(state_dict_from_jax(
        jax.device_get(v["params"]), jax.device_get(v["batch_stats"]),
        STAGES18), strict=True)
    pf.to(memory_format=torch.channels_last).train(train)
    x = np.random.RandomState(1).rand(8, SIZE, SIZE, 3).astype(np.float32)
    if train:
        ref, _ = jf.apply(v, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    else:
        ref = jf.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = pf(torch.from_numpy(x).permute(0, 3, 1, 2))
    ref = np.asarray(ref)
    # conv and BN sums in another order: ~1e-6 of the output in eval
    # mode, ~2e-5 in train mode (batch statistics of 8 images)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("mode,K", [("euclidean", None), ("euc_cone", 3.0)])
def test_label_embedder_matches_jax(mode, K):
    je = JaxLabelEmbedder(n_nodes=9, dim=4, mode=mode, K=K)
    v = je.init(jax.random.PRNGKey(2), jnp.zeros((1,), jnp.int32))
    pe = LabelEmbedder(9, 4, mode=mode, K=K)
    pe.load_state_dict(label_table_from_jax(jax.device_get(v)))
    ids = np.array([0, 3, 8, 3], np.int64)
    with torch.no_grad():
        got = pe(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(je.apply(v, jnp.asarray(ids, jnp.int32))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("energy,variant", [
    ("order", "margin"), ("order", "vendrov"), ("order", "nll"),
    ("euc_cone", "margin"), ("euc_cone", "vendrov")])
def test_step_matches_jax(setup, energy, variant):
    jt, pt = make_pair(setup, energy=energy, loss_variant=variant)
    out_j, out_p, _, want, table = run_step(jt, pt, setup["batch"])
    check_step(out_j, out_p, want, table, pt)


def test_freeze_images_step_matches_jax(setup):
    jt, pt = make_pair(setup, energy="order", freeze_images=True)
    out_j, out_p, before, want, table = run_step(jt, pt, setup["batch"])
    check_step(out_j, out_p, want, table, pt, trunk_trains=False)
    after = pt.featcnn.state_dict()
    for k, v in after.items():
        if k.startswith("trunk.") and "running" not in k \
                and "num_batches" not in k:
            assert torch.equal(v, before[k]), k
    # the running statistics still move (train-mode BN)
    assert not torch.equal(after["trunk.bn1.running_mean"],
                           before["trunk.bn1.running_mean"])
    assert not torch.equal(after["fc.weight"], before["fc.weight"])


def test_freeze_bn_step_matches_jax(setup):
    jt, pt = make_pair(setup, energy="euc_cone", freeze_bn=True)
    out_j, out_p, before, want, table = run_step(jt, pt, setup["batch"])
    check_step(out_j, out_p, want, table, pt)
    for k, v in pt.featcnn.state_dict().items():
        if "running" in k:
            assert torch.equal(v, before[k]), k
