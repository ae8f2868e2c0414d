"""The port's experiment runners (``train/runner.py``) and the tower warm
start (``JointCNNTrainer.load_tower_trunk``) on the CPU, against the JAX
package's runner where the two can be compared.

* ``run_label_embedding``: resume keeps the best-model bookkeeping (the
  twin of tests/test_runner.py::test_embedding_runner_resume_and_threshold_payload),
  the same set of metrics.jsonl tags as the JAX runner on the same
  configuration, and the JAX runner's best table, carried over with
  ``models/jax_import.py``, gives the port the JAX run's reconstruction F1
  and val threshold within 1e-5 (the val negatives are the JAX run's: the
  port's device sampler draws others).
* ``run_joint_cnn`` (ResNet-18 at 32², 2 epochs, then resume to 3): the
  twin of tests/test_runner.py::test_joint_resume_preserves_best_tracking.
* ``load_tower_trunk``: a classifier checkpoint's trunk moves into the
  tower exactly (compared with torch.equal), ``fc`` untouched; a
  mismatched trunk raises.
"""

import argparse
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from learning_embeddings_tpu.hierarchy import (
    label_graph_from_paths as jax_graph, split_edges as jax_split,
    toy_labelmap as jax_toy)
from learning_embeddings_tpu.train import experiment as jexp
from learning_embeddings_tpu.train.embedding import (
    EmbeddingTrainerConfig as JaxConfig)
from learning_embeddings_tpu.train.runner import (
    run_label_embedding as jax_run_label_embedding)
from learning_embeddings_tpu_torch.cli._joint_main import (
    load_tower_warm_start)
from learning_embeddings_tpu_torch.hierarchy import (label_graph_from_paths,
                                                     split_edges,
                                                     toy_labelmap)
from learning_embeddings_tpu_torch.losses.joint_sampling import (
    build_joint_graph)
from learning_embeddings_tpu_torch.models import (
    label_table_from_jax_checkpoint)
from learning_embeddings_tpu_torch.train.classifier import (
    ClassifierConfig, ClassifierTrainer)
from learning_embeddings_tpu_torch.train.embedding import (
    EmbeddingTrainer, EmbeddingTrainerConfig)
from learning_embeddings_tpu_torch.train.experiment import (Checkpointer,
                                                            ExperimentDir)
from learning_embeddings_tpu_torch.train.joint_cnn import (JointCNNConfig,
                                                           JointCNNTrainer)
from learning_embeddings_tpu_torch.train.runner import (run_joint_cnn,
                                                        run_label_embedding)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The runners also log to tensorboard where it imports; here that
    import pulls in TensorFlow (~15 s), so these tests keep to the jsonl
    mirror, which holds the same records."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture
def exp_dir(tmp_path):
    """tmp_path, emptied after the test: a ResNet-18 checkpoint of the
    joint trainer (parameters and two Adam moments) is ~134 MB, and pytest
    keeps the temporary directories of its last runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


SPLIT_KW = dict(proportion_of_nb_edges_in_train=0.5, val_frac=0.15,
                test_frac=0.15, seed=0)
#: the JAX runner test's configuration
CFG = dict(energy="order", embedding_dim=4, lr=0.01, batch_size=10,
           neg_to_pos_ratio=3, alpha=1.0, optimizer="adam", seed=0)


def toy_splits():
    lm = toy_labelmap(3, 3)
    return lm, split_edges(label_graph_from_paths(lm.leaf_paths(), lm),
                           **SPLIT_KW)


def metrics(exp):
    with open(os.path.join(exp.logs, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# ----------------------------------------------------------------------
# run_label_embedding
# ----------------------------------------------------------------------
def test_label_runner_resume_keeps_best_tracking(tmp_path):
    lm, splits = toy_splits()
    cfg = EmbeddingTrainerConfig(device="cpu", **CFG)
    kw = dict(experiment_dir=str(tmp_path), experiment_name="emb",
              n_epochs=3, eval_interval=1, check_reconstr_every=2)
    res = run_label_embedding(lm, splits, cfg, **kw)
    assert res["best_val_f1"] > 0
    assert "test_f1" in res
    res2 = run_label_embedding(lm, splits, cfg,
                               **{**kw, "n_epochs": 5, "resume": True})
    exp = res2["experiment"]
    ck = Checkpointer(exp)
    assert ck.find_existing_weights() == 4
    # the second run trained epochs 3 and 4 only
    steps = [r["step"] for r in metrics(exp) if r["tag"] == "train/loss"]
    assert steps == [0, 1, 2, 3, 4]
    # optimal_threshold and best-tracking ride in the checkpoint payload
    payload = ck.load(4, {"params": None, "optimal_threshold": 0.0,
                          "best_f1": -1.0, "best_epoch": -1.0})
    assert payload["optimal_threshold"] > 0.0
    assert payload["best_f1"] == pytest.approx(res2["best_val_f1"])
    # best_model holds the best val F1 of all five epochs
    val = {r["step"]: r["value"] for r in metrics(exp)
           if r["tag"] == "val/f1"}
    assert res2["best_val_f1"] == pytest.approx(max(val.values()))
    assert res2["best_epoch"] == max(val, key=val.get)
    best = ck.load("best_model", {"best_f1": -1.0, "best_epoch": -1.0})
    assert best["best_f1"] == pytest.approx(res2["best_val_f1"])
    # resume past completion: no epoch runs, yet the original best is
    # restored from the checkpoint (not reset to -1) and reported
    res3 = run_label_embedding(lm, splits, cfg,
                               **{**kw, "n_epochs": 5, "resume": True})
    assert res3["best_val_f1"] == pytest.approx(res2["best_val_f1"])
    assert res3["best_epoch"] == res2["best_epoch"]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX runner on the configuration of CFG, 3 epochs."""
    jlm = jax_toy(3, 3)
    jsplits = jax_split(jax_graph(jlm.leaf_paths(), jlm), **SPLIT_KW)
    with pytest.MonkeyPatch.context() as mp:   # as no_tensorboard does
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        return jax_run_label_embedding(
            jlm, jsplits, JaxConfig(donate=False, **CFG),
            experiment_dir=str(tmp_path_factory.mktemp("jax")),
            experiment_name="emb", n_epochs=3, eval_interval=1,
            check_reconstr_every=2, mesh=None)


def test_label_runner_logs_the_jax_runners_tags(tmp_path, jax_run):
    lm, splits = toy_splits()
    res = run_label_embedding(lm, splits,
                              EmbeddingTrainerConfig(device="cpu", **CFG),
                              experiment_dir=str(tmp_path),
                              experiment_name="emb", n_epochs=3,
                              eval_interval=1, check_reconstr_every=2)
    got, want = metrics(res["experiment"]), metrics(jax_run["experiment"])
    assert {r["tag"] for r in got} == {r["tag"] for r in want}
    assert sorted((r["tag"], r["step"]) for r in got) == \
        sorted((r["tag"], r["step"]) for r in want)
    assert sorted(os.listdir(res["experiment"].weights)) == \
        sorted(os.listdir(jax_run["experiment"].weights))


def test_jax_best_table_carried_over(jax_run):
    """The JAX run's best_model, read with the JAX Checkpointer's
    load_raw and carried over: the port's reconstruction F1 equals the
    JAX run's final one, and the port's val pass over the JAX run's val
    negatives finds the threshold the checkpoint carries (and the JAX run
    logged at its best epoch), within 1e-5."""
    raw = jexp.Checkpointer(jax_run["experiment"]).load_raw("best_model")
    table, threshold = label_table_from_jax_checkpoint(raw)
    assert threshold is not None

    lm, splits = toy_splits()
    assert np.array_equal(splits.val,
                          np.asarray(jax_run["trainer"].splits.val))
    tr = EmbeddingTrainer(lm, splits,
                          EmbeddingTrainerConfig(device="cpu", **CFG))
    tr.model.load_state_dict(table)
    rec = tr.reconstruction()
    assert abs(float(rec.f1) - jax_run["reconstruction_f1"]) <= 1e-5

    nf, nt = jax_run["trainer"]._edge_set_with_negatives("val")
    tr._eval_negatives["val"] = (np.asarray(nf), np.asarray(nt))
    val = tr.evaluate("val")
    assert abs(float(val.threshold) - threshold) <= 1e-5
    assert abs(float(val.f1) - jax_run["best_val_f1"]) <= 1e-5
    logged = {r["step"]: r["value"] for r in metrics(jax_run["experiment"])
              if r["tag"] == "val/threshold"}
    assert abs(logged[jax_run["best_epoch"]] - threshold) <= 1e-5


def test_label_runner_plots_frames_at_dim_2(tmp_path):
    pytest.importorskip("matplotlib")
    lm, splits = toy_splits()
    cfg = EmbeddingTrainerConfig(device="cpu", **dict(
        CFG, energy="hyp_cone", embedding_dim=2))
    res = run_label_embedding(lm, splits, cfg, experiment_dir=str(tmp_path),
                              experiment_name="d2", n_epochs=1)
    assert os.path.isfile(os.path.join(res["experiment"].stats, "frames",
                                       "epoch_0000.png"))


def test_runners_refuse_a_mesh(tmp_path):
    lm, splits = toy_splits()
    with pytest.raises(NotImplementedError, match="item 21"):
        run_label_embedding(lm, splits,
                            EmbeddingTrainerConfig(device="cpu", **CFG),
                            experiment_dir=str(tmp_path),
                            experiment_name="m", n_epochs=1, mesh=object())
    graph, edges = build_joint_graph(lm, lm.leaf_paths())
    with pytest.raises(NotImplementedError, match="item 21"):
        run_joint_cnn(lm, graph, edges, None, JointCNNConfig(device="cpu"),
                      experiment_dir=str(tmp_path), experiment_name="j",
                      n_epochs=1, mesh="data")


# ----------------------------------------------------------------------
# run_joint_cnn
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def joint_setup():
    lm = toy_labelmap(2, 3)
    rng = np.random.RandomState(0)
    leaves = np.repeat(np.arange(lm.levels[-1]), 2)
    ll = lm.leaf_paths()[leaves]
    graph, train_edges = build_joint_graph(lm, ll)
    bank = rng.randint(0, 256, (len(leaves), 32, 32, 3)).astype(np.uint8)

    def loader(rows):
        return bank[np.asarray(rows) % len(bank)]

    paths = ll + np.asarray(lm.level_start)[None, :]
    cfg = JointCNNConfig(energy="hyp_cone", backbone="resnet18",
                         embedding_dim=4, image_size=32, batch_size=8,
                         neg_to_pos_ratio=3, alpha=0.05,
                         tower_dtype="float32", device="cpu")
    return lm, graph, train_edges, loader, paths, cfg


def test_joint_cnn_runner_resume_keeps_best_tracking(joint_setup, exp_dir,
                                                     capsys):
    lm, graph, edges, loader, paths, cfg = joint_setup
    kw = dict(experiment_dir=str(exp_dir), experiment_name="jres",
              n_epochs=2, eval_interval=1, eval_max_images=12,
              eval_sets={"val": (paths, loader), "test": (paths, loader)})
    res1 = run_joint_cnn(lm, graph, edges, loader, cfg, **kw)
    assert res1["best_epoch"] >= 0
    exp = res1["experiment"]
    assert sorted(os.listdir(exp.weights)) == ["0", "1", "best_model"]
    assert "capping val eval at 12 of 16 images" in capsys.readouterr().out
    assert set(res1["test_metrics"]) >= {"micro_f1", "edge_f1"}
    assert res1["trainer"].optimal_threshold is not None
    # resume past completion: no epoch runs, yet the original best is
    # reloaded and reported
    res2 = run_joint_cnn(lm, graph, edges, loader, cfg,
                         **{**kw, "resume": True})
    assert res2["best_val_micro_f1"] == pytest.approx(
        res1["best_val_micro_f1"])
    assert res2["best_epoch"] == res1["best_epoch"]
    # resume with one more epoch: it starts at epoch 2, best never drops
    res3 = run_joint_cnn(lm, graph, edges, loader, cfg,
                         **{**kw, "n_epochs": 3, "resume": True})
    assert res3["best_val_micro_f1"] >= res1["best_val_micro_f1"]
    steps = [r["step"] for r in metrics(exp) if r["tag"] == "train/loss"]
    assert steps == [0, 1, 2]
    best = Checkpointer(exp).load("best_model", {"best_f1": -1.0,
                                                 "best_epoch": -1.0})
    assert best["best_f1"] == pytest.approx(res3["best_val_micro_f1"])


def test_joint_cnn_runner_takes_its_warm_starts(joint_setup, tmp_path):
    """init_embeddings, init_threshold and init_tower reach the trainer;
    with no epoch to run, the test pass scores at the given threshold."""
    lm, graph, edges, loader, paths, cfg = joint_setup
    table = np.random.RandomState(1).uniform(
        0.3, 0.5, (graph.n_labels, 4)).astype(np.float32)
    donor = JointCNNTrainer(lm, graph, edges, loader,
                            JointCNNConfig(**{**cfg.__dict__, "seed": 9}))
    trunk = donor.featcnn.trunk
    init_tower = (dict(trunk.named_parameters()),
                  dict(trunk.named_buffers()))
    res = run_joint_cnn(lm, graph, edges, loader, cfg,
                        experiment_dir=str(tmp_path), experiment_name="w",
                        n_epochs=0, eval_sets={"val": (paths, loader),
                                               "test": (paths, loader)},
                        init_embeddings=table, init_threshold=0.7,
                        init_tower=init_tower)
    tr = res["trainer"]
    assert tr.optimal_threshold == 0.7 and res["best_epoch"] == -1
    for k, v in trunk.state_dict().items():
        assert torch.equal(tr.featcnn.trunk.state_dict()[k], v), k
    want = JointCNNTrainer(lm, graph, edges, loader, cfg)
    want.load_embedding_table(table)
    assert torch.equal(tr.embedder.embedding, want.embedder.embedding)


# ----------------------------------------------------------------------
# load_tower_trunk
# ----------------------------------------------------------------------
def _classifier_checkpoint(lm, tmp_path, backbone="resnet18"):
    ct = ClassifierTrainer(lm, ClassifierConfig(
        backbone=backbone, image_size=32, batch_size=4, seed=3,
        dtype=torch.float32, device="cpu"))
    # running statistics that differ from a fresh tower's
    with torch.no_grad():
        for name, buf in ct.model.named_buffers():
            buf.add_(0.25)
    exp = ExperimentDir(str(tmp_path), "cls")
    Checkpointer(exp).save("best_model", ct.checkpoint_payload())
    return ct, os.path.join(exp.weights, "best_model")


def test_load_tower_trunk_moves_the_classifier_trunk(joint_setup, exp_dir):
    lm, graph, edges, loader, _, cfg = joint_setup
    ct, path = _classifier_checkpoint(lm, exp_dir)
    trunk, stats = load_tower_warm_start(
        argparse.Namespace(load_tower_from=path))
    tr = JointCNNTrainer(lm, graph, edges, loader, cfg)
    fc = {k: v.clone() for k, v in tr.featcnn.fc.state_dict().items()}
    tr.load_tower_trunk(trunk, stats)
    got = tr.featcnn.trunk.state_dict()
    want = ct.model.trunk.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for k, v in tr.featcnn.fc.state_dict().items():
        assert torch.equal(v, fc[k]), k
    # the tower still steps from the carried trunk
    loss, _, _ = tr.train_batch(edges[:8, 0], edges[:8, 1])
    assert np.isfinite(loss)


def test_load_tower_trunk_refuses_a_mismatch(joint_setup, exp_dir):
    lm, graph, edges, loader, _, cfg = joint_setup
    _, path = _classifier_checkpoint(lm, exp_dir)
    trunk, stats = load_tower_warm_start(
        argparse.Namespace(load_tower_from=path))
    tr = JointCNNTrainer(lm, graph, edges, loader, cfg)
    bad = dict(trunk)
    bad["conv0.weight"] = bad.pop("conv1.weight")
    with pytest.raises(ValueError, match="trunk param mismatch.*conv1"):
        tr.load_tower_trunk(bad, stats)
    # a checkpoint with no trunk (a label-only one) is refused up front
    exp = ExperimentDir(str(exp_dir), "lab")
    Checkpointer(exp).save("best_model", {"params": {
        "embedding": torch.zeros(3, 4)}, "optimal_threshold": 0.1})
    with pytest.raises(ValueError, match="no 'trunk"):
        load_tower_warm_start(argparse.Namespace(
            load_tower_from=os.path.join(exp.weights, "best_model")))
