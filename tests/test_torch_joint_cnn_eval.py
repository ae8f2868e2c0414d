"""The port's --use_CNN joint trainer on the CPU, continued: one epoch of
train_epoch with prefetch, then the eval sequence the JAX package's runner
runs (image embeddings of a split, classification metrics, val edge
metrics, reconstruction, test metrics at the calibrated threshold), each
against the JAX trainer from the same weights; and the port's own
contracts (checkpoint payload, warm start, options that are not ported).

The epoch trains the tower at lr_images 1e-5: Adam's first steps move
every weight by about ±lr, the sign of a gradient within rounding of 0 is
noise on both sides, and at 1e-3 those few flipped entries change the
loss of the steps after them by ~0.1% (measured), at 1e-5 by ~1e-6."""

import numpy as np
import pytest
import torch

from learning_embeddings_tpu_torch.train.joint_cnn import (
    JointCNNConfig, JointCNNTrainer)

from test_torch_joint_cnn import make_pair, setup  # noqa: F401 (fixture)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def trained(setup):   # noqa: F811 (the imported fixture)
    """Both trainers after one epoch (3 steps, prefetch on) over 24
    label→image edges, one per train image."""
    img_edges = setup["edges"][setup["edges"][:, 1] >= setup["graph"]
                               .n_labels]
    jt, pt = make_pair(dict(setup, edges=img_edges[::3]), energy="order",
                       lr_images=1e-5, prefetch=True, inflight_steps=2)
    stats = (jt.train_epoch(0, np.random.RandomState(1)),
             pt.train_epoch(0, np.random.RandomState(1)))
    return jt, pt, stats


def test_train_epoch_with_prefetch_matches_jax(trained):
    _, _, (ref, got) = trained
    assert set(got) == set(ref)
    for k, v in ref.items():
        # three steps of f32 rounding in another order (see module doc)
        assert got[k] == pytest.approx(v, rel=1e-5), k


def test_prefetch_gives_the_same_epoch(setup):  # noqa: F811
    img_edges = setup["edges"][setup["edges"][:, 1] >= setup["graph"]
                               .n_labels][::3]
    runs = []
    for prefetch in (True, False):
        tr = JointCNNTrainer(setup["lm"], setup["graph"], img_edges,
                             setup["loader"], JointCNNConfig(
                                 energy="order", backbone="resnet18",
                                 embedding_dim=4,
                                 image_size=32, batch_size=8,
                                 tower_dtype="float32", prefetch=prefetch,
                                 device="cpu"))
        runs.append(tr.train_epoch(0, np.random.RandomState(1)))
    assert runs[0] == runs[1]


def _split(setup, n, seed):  # noqa: F811
    """(rows, global label paths) of a held-out split of n images."""
    lm = setup["lm"]
    rng = np.random.RandomState(seed)
    paths = (lm.leaf_paths()[rng.randint(0, lm.levels[-1], n)]
             + np.asarray(lm.level_start)[None, :]).astype(np.int32)
    return rng.permutation(24)[:n], paths


def test_eval_sequence_matches_jax(setup, trained):  # noqa: F811
    jt, pt, _ = trained
    val_rows, val_paths = _split(setup, 13, seed=2)
    test_rows, test_paths = _split(setup, 11, seed=3)

    # 1. image embeddings, in chunks of 5 with a padded ragged tail
    emb_j = jt.image_embeddings_for_rows(val_rows, batch_size=5)
    emb_p = pt.image_embeddings_for_rows(val_rows, batch_size=5)
    assert emb_p.shape == (13, 4)
    # eval-mode f32 forward: conv sums in another order
    np.testing.assert_allclose(emb_p, emb_j, rtol=1e-4,
                               atol=1e-4 * np.abs(emb_j).max())
    np.testing.assert_allclose(pt.label_embeddings().numpy(),
                               np.asarray(jt.label_embeddings()),
                               rtol=0, atol=1e-5)

    # 2. ranking metrics (labels × images energies)
    got = pt.classification_metrics(val_paths, emb_p)
    ref = jt.classification_metrics(val_paths, emb_j)
    np.testing.assert_array_equal(got.pop("top1_per_level"),
                                  ref.pop("top1_per_level"))
    for k, v in ref.items():
        assert got[k] == pytest.approx(v, rel=1e-4), k

    # 3. val edge metrics calibrate the threshold
    em_p = pt.edge_metrics(val_paths, emb_p)
    em_j = jt.edge_metrics(val_paths, emb_j)
    for name, a, b in zip(em_j._fields, em_p, em_j):
        assert float(a) == pytest.approx(float(b), rel=1e-4), name
    pt.optimal_threshold = float(em_p.threshold)
    jt.optimal_threshold = float(em_j.threshold)

    # 4. reconstruction (labels × labels energies)
    rec_p, rec_j = pt.reconstruction(), jt.reconstruction()
    for name, a, b in zip(rec_j._fields, rec_p, rec_j):
        assert float(a) == pytest.approx(float(b), rel=1e-4), name

    # 5. test metrics at the calibrated threshold
    emb_p = pt.image_embeddings_for_rows(test_rows, batch_size=5)
    emb_j = jt.image_embeddings_for_rows(test_rows, batch_size=5)
    got = pt.classification_metrics(test_paths, emb_p)
    ref = jt.classification_metrics(test_paths, emb_j)
    assert got["micro_f1"] == pytest.approx(ref["micro_f1"], rel=1e-6)
    em_p = pt.edge_metrics(test_paths, emb_p,
                           threshold=pt.optimal_threshold)
    em_j = jt.edge_metrics(test_paths, emb_j,
                           threshold=jt.optimal_threshold)
    for name, a, b in zip(em_j._fields, em_p, em_j):
        assert float(a) == pytest.approx(float(b), rel=1e-4), name


def _port(setup, **kw):  # noqa: F811
    cfg = dict(energy="order", backbone="resnet18", embedding_dim=4,
               image_size=32, batch_size=8, tower_dtype="float32",
               device="cpu")
    cfg.update(kw)
    return JointCNNTrainer(setup["lm"], setup["graph"], setup["edges"],
                           setup["loader"], JointCNNConfig(**cfg))


def test_checkpoint_payload_round_trip(setup):  # noqa: F811
    tr = _port(setup)
    batch = setup["batch"]
    tr.train_batch(batch[:, 0], batch[:, 1])
    tr.optimal_threshold = 0.25
    fresh = _port(setup, seed=1)
    fresh.restore_payload(tr.checkpoint_payload())
    assert fresh.optimal_threshold == 0.25
    fresh._rng = np.random.RandomState(5)
    tr._rng = np.random.RandomState(5)
    la, _, _ = tr.train_batch(batch[:, 0], batch[:, 1])
    lb, _, _ = fresh.train_batch(batch[:, 0], batch[:, 1])
    assert la == lb


def test_load_embedding_table(setup):  # noqa: F811
    tr = _port(setup)
    table = np.arange(tr.graph.n_labels * 4, dtype=np.float32) \
        .reshape(-1, 4)
    tr.load_embedding_table(table)
    np.testing.assert_array_equal(tr.embedder.embedding.detach().numpy(),
                                  table)
    with pytest.raises(ValueError, match="expected exactly 1"):
        tr.load_embedding_table(table[:, :3])


def test_curriculum_stages(setup):  # noqa: F811
    tr = _port(setup, hide_levels=True)
    assert tr.levels_for_epoch(0) == (1, 2, 3)
    assert tr.levels_for_epoch(60) == (3,)
    tr.set_levels_to_hide((1,))
    assert tr.cfg.levels_to_hide == (1,)
    assert _port(setup, levels_to_hide=(2,)).levels_for_epoch(99) == (2,)


@pytest.mark.parametrize("kw,err,match", [
    (dict(backbone="vgg11"), ValueError, "backbone"),
    (dict(energy="order", optimizer_labels="rsgd"), ValueError,
     "hyperbolic-cone"),
    (dict(energy="euc_cone", optimizer_labels="radam"), ValueError,
     "hyperbolic-cone"),
    (dict(energy="euc_cone", loss_variant="nll"), ValueError, "order"),
    (dict(bn_stats_dtype="float16"), ValueError, "bn_stats_dtype"),
])
def test_unported_or_invalid_options_raise(setup, kw, err, match):  # noqa
    with pytest.raises(err, match=match):
        _port(setup, **kw)


def test_mesh_and_missing_card_raise(setup):  # noqa: F811
    """A mesh must be a parallel.mesh.Mesh (meshed runs:
    tests/test_torch_mesh_joint.py)."""
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        JointCNNTrainer(setup["lm"], setup["graph"], setup["edges"],
                        setup["loader"], JointCNNConfig(energy="order",
                                                        device="cpu"),
                        mesh=object())
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _port(setup, device="cuda")
