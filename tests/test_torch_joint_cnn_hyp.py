"""The port's --use_CNN joint trainer with the hyperbolic-cone energy
against the JAX package's on the CPU, for each label optimizer: adam (the
hybrid: conformal rescale, the shared Adam step, the annulus projection of
the label table), rsgd (RiemannianSGD, no projection) and radam
(RiemannianAdam, then the projection).

Weights are carried across with state_dict_from_jax and
label_table_from_jax; ResNet-18 at 32², f32 tower, the toy taxonomy and
images of test_torch_joint_cnn.py, three steps over 8 label→image edges
each (16 distinct tower images a step), then the eval sequence.

Tolerances: the loss rel 1e-4 and the label table abs 1e-5 after every
step; the eval's F1 values within 1e-6 of each other. The tower trains at
lr 1e-5, as in test_torch_joint_cnn_eval.py: Adam's step moves a weight
whose gradient is rounding noise by ±lr on either side."""

import numpy as np
import pytest
import torch

import jax

from learning_embeddings_tpu.train.joint import (
    load_label_table as jax_load_label_table)
from learning_embeddings_tpu_torch.geometry import inner_radius
from learning_embeddings_tpu_torch.train.joint_cnn import (
    JointCNNConfig, JointCNNTrainer)

from test_torch_joint_cnn import make_pair, setup  # noqa: F401 (fixture)

torch.set_num_threads(2)

R0 = inner_radius(0.1)


def _batches(setup):  # noqa: F811
    img_edges = setup["edges"][setup["edges"][:, 1] >= setup["graph"]
                               .n_labels][::3]
    return [img_edges[8 * k:8 * (k + 1)] for k in range(3)]


def _val(setup, n, seed):  # noqa: F811
    lm = setup["lm"]
    rng = np.random.RandomState(seed)
    paths = (lm.leaf_paths()[rng.randint(0, lm.levels[-1], n)]
             + np.asarray(lm.level_start)[None, :]).astype(np.int32)
    return rng.permutation(24)[:n], paths


def _check_annulus(table, project):
    norms = np.linalg.norm(table, axis=1)
    if project:
        assert (norms >= R0 - 1e-6).all() and (norms <= 1 - 1e-5 + 1e-6).all()
    assert np.isfinite(table).all()


@pytest.fixture(scope="module", params=["adam", "rsgd", "radam"])
def trained(request, setup):  # noqa: F811
    """Both trainers after three steps, with each step's outputs."""
    jt, pt = make_pair(setup, energy="hyp_cone",
                       optimizer_labels=request.param, lr_images=1e-5)
    steps = []
    for batch in _batches(setup):
        prep_j = jt.prepare_batch(batch[:, 0], batch[:, 1])
        prep_p = pt.prepare_batch(batch[:, 0], batch[:, 1])
        for a, b in zip(prep_j, prep_p):   # the same host negatives
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        out_j = jt.train_prepared(prep_j)
        out_p = pt.train_prepared(prep_p)
        steps.append((float(out_j[0]), float(out_p[0]),
                      np.asarray(jax.device_get(
                          jt.params["labels"]["params"]["embedding"])),
                      pt.embedder.embedding.detach().numpy().copy()))
    return request.param, jt, pt, steps


def test_steps_match_jax(trained):
    name, _, _, steps = trained
    for k, (lj, lp, table_j, table_p) in enumerate(steps):
        assert np.isfinite(lp)
        assert lp == pytest.approx(lj, rel=1e-4), k
        np.testing.assert_allclose(table_p, table_j, rtol=0, atol=1e-5,
                                   err_msg=f"{name} step {k}")
        _check_annulus(table_p, project=name != "rsgd")
    # the table moved
    assert not np.allclose(steps[0][3], steps[-1][3], atol=1e-4)


def test_optimizer_layout(trained):
    name, _, pt, _ = trained
    if name == "adam":   # one Adam, labels as its first group
        assert pt.label_optimizer is None and pt._conformal
        assert len(pt.optimizer.param_groups) == 2
        assert pt.optimizer.param_groups[0]["lr"] == 1e-2
    else:
        assert type(pt.label_optimizer).__name__ == {
            "rsgd": "RiemannianSGD", "radam": "RiemannianAdam"}[name]
        assert pt.label_optimizer.param_groups[0]["lr"] == 1e-2
        assert len(pt.optimizer.param_groups) == 1
        assert pt.optimizer.param_groups[0]["lr"] == 1e-5
    assert pt._project == (name != "rsgd")


def test_eval_matches_jax(setup, trained):  # noqa: F811
    _, jt, pt, _ = trained
    val_rows, val_paths = _val(setup, 13, seed=2)
    test_rows, test_paths = _val(setup, 11, seed=3)
    emb_j = jt.image_embeddings_for_rows(val_rows, batch_size=5)
    emb_p = pt.image_embeddings_for_rows(val_rows, batch_size=5)
    np.testing.assert_allclose(emb_p, emb_j, rtol=1e-4,
                               atol=1e-4 * np.abs(emb_j).max())
    # every embedding in the annulus (the hyp_cone_exp0 post-map)
    for e in (emb_p, pt.label_embeddings().numpy()):
        norms = np.linalg.norm(e, axis=1)
        assert (norms >= R0 - 1e-6).all() and (norms < 1.0).all()

    got = pt.classification_metrics(val_paths, emb_p)
    ref = jt.classification_metrics(val_paths, emb_j)
    np.testing.assert_array_equal(got.pop("top1_per_level"),
                                  ref.pop("top1_per_level"))
    for k, v in ref.items():
        # the norm statistics follow the embeddings (rel 1e-4); the hit
        # rates and F1 values are ratios of counts and agree exactly
        tol = dict(rel=1e-4) if "norm" in k else dict(abs=1e-6)
        assert got[k] == pytest.approx(v, **tol), k

    em_p = pt.edge_metrics(val_paths, emb_p)
    em_j = jt.edge_metrics(val_paths, emb_j)
    assert float(em_p.f1) == pytest.approx(float(em_j.f1), abs=1e-6)
    assert float(em_p.threshold) == pytest.approx(float(em_j.threshold),
                                                  rel=1e-4, abs=1e-5)
    pt.optimal_threshold = float(em_p.threshold)
    jt.optimal_threshold = float(em_j.threshold)

    rec_p, rec_j = pt.reconstruction(), jt.reconstruction()
    assert float(rec_p.f1) == pytest.approx(float(rec_j.f1), abs=1e-6)

    emb_p = pt.image_embeddings_for_rows(test_rows, batch_size=5)
    emb_j = jt.image_embeddings_for_rows(test_rows, batch_size=5)
    em_p = pt.edge_metrics(test_paths, emb_p, threshold=pt.optimal_threshold)
    em_j = jt.edge_metrics(test_paths, emb_j, threshold=jt.optimal_threshold)
    for name, a, b in zip(em_j._fields, em_p, em_j):
        assert float(a) == pytest.approx(float(b), rel=1e-4, abs=1e-6), name


def _port(setup, **kw):  # noqa: F811
    cfg = dict(backbone="resnet18", embedding_dim=4, image_size=32,
               batch_size=8, tower_dtype="float32", device="cpu")
    cfg.update(kw)
    return JointCNNTrainer(setup["lm"], setup["graph"], setup["edges"],
                           setup["loader"], JointCNNConfig(**cfg))


def test_default_energy_is_hyp_cone(setup):  # noqa: F811
    tr = _port(setup)
    assert tr.cfg.energy == "hyp_cone" and tr.K == 0.1
    assert tr.embedder.mode == tr.featcnn.mode == "hyp_cone_exp0"
    norms = tr.embedder.embedding.detach().norm(dim=1)
    assert bool(((norms >= R0 - 1e-6) & (norms <= R0 + 0.05 + 1e-6)).all())


@pytest.mark.parametrize("scale", [0.5, 3.0])
def test_load_embedding_table_rescales_like_jax(setup, scale):  # noqa
    """A table outside the annulus is rescaled (as the JAX package's
    load_label_table does); one inside it loads unchanged."""
    tr = _port(setup)
    rng = np.random.RandomState(4)
    table = rng.randn(tr.graph.n_labels, 4).astype(np.float32)
    table *= scale * rng.uniform(0.3, 1.0, (len(table), 1)) / np.linalg.norm(
        table, axis=1, keepdims=True)
    tr.load_embedding_table(table)
    want = jax_load_label_table({"params": {"embedding": np.zeros_like(
        table)}}, table, "hyp_cone", 0.1)["params"]["embedding"]
    got = tr.embedder.embedding.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)
    if scale == 3.0:
        assert not np.allclose(got, table)
    else:
        np.testing.assert_array_equal(got, table)


@pytest.mark.parametrize("opt", ["rsgd", "radam"])
def test_checkpoint_round_trip_with_a_label_optimizer(setup, opt):  # noqa
    tr = _port(setup, optimizer_labels=opt)
    batch = setup["batch"]
    tr.train_batch(batch[:, 0], batch[:, 1])
    payload = tr.checkpoint_payload()
    assert "label_opt_state" in payload
    fresh = _port(setup, optimizer_labels=opt, seed=1)
    fresh.restore_payload(payload)
    for t in (tr, fresh):
        t._rng = np.random.RandomState(5)
    la, _, _ = tr.train_batch(batch[:, 0], batch[:, 1])
    lb, _, _ = fresh.train_batch(batch[:, 0], batch[:, 1])
    assert la == lb
    assert torch.equal(tr.embedder.embedding, fresh.embedder.embedding)
