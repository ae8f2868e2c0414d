"""The port's experiment scaffolding (``train/experiment.py``), image decode
and augment (``data/pipeline.py``) and the carry-over of JAX embedding
checkpoints (``models/jax_import.py``), against the JAX package on the CPU.

Tolerances: the manifest's bytes, the decoded and augmented pixels and
every checkpoint round trip are compared exactly (no arithmetic happens
between the two sides); the optimizer step after a restore is compared
exactly too (the same f32 operations on the same state)."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from learning_embeddings_tpu.data import pipeline as jpipe
from learning_embeddings_tpu.train import experiment as jexp
from learning_embeddings_tpu_torch.data import pipeline as tpipe
from learning_embeddings_tpu_torch.hierarchy import (label_graph_from_paths,
                                                     split_edges,
                                                     toy_labelmap)
from learning_embeddings_tpu_torch.models import (
    label_table_from_jax_checkpoint)
from learning_embeddings_tpu_torch.train import experiment as texp
from learning_embeddings_tpu_torch.train.embedding import (
    EmbeddingTrainer, EmbeddingTrainerConfig)

torch.set_num_threads(2)


# ----------------------------------------------------------------------
# manifest
# ----------------------------------------------------------------------
MANIFEST = {"lr": 0.001, "batch_size": 8, "debug": False, "loss": "hyp_cones_loss",
            "lr_step": [10, 20], "level_weights": None, "alpha": 1e-05,
            "experiment_name": "m", "taxonomy": "butterfly200",
            "note": "a: b", "zeta": (1, 2)}


def test_manifest_bytes_equal_the_jax_package(tmp_path):
    """The same dict written by both: identical bytes, the same dict read
    back by both readers."""
    jdir = jexp.ExperimentDir(str(tmp_path / "jax"), "m")
    tdir = texp.ExperimentDir(str(tmp_path / "torch"), "m")
    jexp.write_manifest(jdir, MANIFEST)
    texp.write_manifest(tdir, MANIFEST)
    with open(jdir.manifest_path, "rb") as f:
        jbytes = f.read()
    with open(tdir.manifest_path, "rb") as f:
        tbytes = f.read()
    assert tbytes == jbytes
    assert b"git_commit: " in tbytes and b"git_branch: " in tbytes
    got = texp.read_manifest(tdir.manifest_path)
    assert got == jexp.read_manifest(jdir.manifest_path)
    assert got["note"] == "a: b" and got["lr_step"] == "[10, 20]"


def test_experiment_dir_layout(tmp_path):
    exp = texp.ExperimentDir(str(tmp_path), "run")
    for sub in ("weights", "logs", "stats"):
        assert os.path.isdir(os.path.join(str(tmp_path), "run", sub))
    assert exp.manifest_path == os.path.join(str(tmp_path), "run",
                                             "config_params.txt")


# ----------------------------------------------------------------------
# image decode and augment
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def png(tmp_path_factory):
    from PIL import Image

    rng = np.random.RandomState(0)
    arr = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    path = str(tmp_path_factory.mktemp("img") / "x.png")
    Image.fromarray(arr).save(path)
    return path, arr


@pytest.mark.parametrize("grayscale", [False, True])
def test_decode_image_equals_jax(png, grayscale):
    path, arr = png
    got = tpipe.decode_image(path, grayscale=grayscale)
    assert np.array_equal(got, jpipe.decode_image(path, grayscale=grayscale))
    if not grayscale:
        assert np.array_equal(got, arr)   # PNG is lossless, RGB order


def test_decode_image_pil_fallback_equals_jax(png, monkeypatch):
    """Without cv2 the port decodes with PIL, as the JAX module does: the
    same RGB pixels as cv2, and PIL's own grayscale conversion (which
    rounds differently from cv2's)."""
    from PIL import Image

    path, arr = png
    monkeypatch.setattr(tpipe, "_cv2", lambda: None)
    assert np.array_equal(tpipe.decode_image(path),
                          jpipe.decode_image(path))
    assert np.array_equal(tpipe.decode_image(path, grayscale=True),
                          np.asarray(Image.open(path).convert("L"))[..., None])


def test_decode_image_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tpipe.decode_image(str(tmp_path / "none.png"))


@pytest.mark.parametrize("size", [16, 32, 64])
def test_augment_eval_and_joint_train_equal_jax(png, size):
    path, _ = png
    img = tpipe.decode_image(path)
    assert np.array_equal(tpipe.augment_eval(img, size),
                          jpipe.augment_eval(img, size))
    for seed in range(4):   # both hflip outcomes occur in these seeds
        got = tpipe.augment_joint_train(img, size,
                                        np.random.RandomState(seed))
        want = jpipe.augment_joint_train(img, size,
                                         np.random.RandomState(seed))
        assert got.shape == (size, size, 3)
        assert np.array_equal(got, want)


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------
def test_checkpoint_round_trip(tmp_path):
    exp = texp.ExperimentDir(str(tmp_path), "ckpt")
    ckpt = texp.Checkpointer(exp)
    payload = {"params": {"w": torch.arange(12.0).reshape(3, 4)},
               "opt_state": {"step": 7, "betas": (0.9, 0.999)},
               "optimal_threshold": float("nan"), "best_f1": 0.5}
    ckpt.save(3, payload, wait=False)
    ckpt.save("best_model", payload)
    ckpt.wait_until_finished()
    # one file per name, no extension, nothing else left behind
    assert sorted(os.listdir(exp.weights)) == ["3", "best_model"]
    raw = ckpt.load_raw(3)
    assert torch.equal(raw["params"]["w"], payload["params"]["w"])
    assert raw["params"]["w"].device.type == "cpu"
    assert raw["opt_state"] == {"step": 7, "betas": (0.9, 0.999)}
    assert np.isnan(raw["optimal_threshold"]) and raw["best_f1"] == 0.5
    assert ckpt.find_existing_weights() == 3


def test_checkpointer_load_tolerates_key_drift(tmp_path):
    """Keys the template does not ask for are dropped; template keys the
    file lacks take the template's value (the port's twin of
    tests/test_runner.py::test_checkpointer_load_tolerates_key_drift)."""
    ckpt = texp.Checkpointer(texp.ExperimentDir(str(tmp_path), "drift"))
    ckpt.save(1, {"params": {"w": torch.ones(2, 2)}, "extra": 5.0})
    out = ckpt.load(1, {"params": {"w": torch.zeros(2, 2)}})
    assert "extra" not in out
    assert torch.equal(out["params"]["w"], torch.ones(2, 2))
    out2 = ckpt.load(1, {"params": {"w": torch.zeros(2, 2)},
                         "missing": -1.0})
    assert out2["missing"] == -1.0
    assert torch.equal(out2["params"]["w"], torch.ones(2, 2))


def test_find_existing_weights(tmp_path):
    exp = texp.ExperimentDir(str(tmp_path), "find")
    ckpt = texp.Checkpointer(exp)
    assert ckpt.find_existing_weights() is None
    for name in (0, 2, 10, "best_model"):
        ckpt.save(name, {"x": torch.zeros(1)})
    with open(os.path.join(exp.weights, "notes"), "w") as f:
        f.write("not a checkpoint")
    assert ckpt.epochs_on_disk() == [0, 2, 10]
    assert ckpt.find_existing_weights() == 10   # numeric, not lexical
    assert "best_model" in os.listdir(exp.weights)


@pytest.mark.parametrize("energy,optimizer", [("order", "adam"),
                                              ("hyp_cone", "rsgd"),
                                              ("hyp_cone", "radam"),
                                              ("order", "sgd")])
def test_trainer_state_survives_a_checkpoint(tmp_path, energy, optimizer):
    """A label-only trainer's payload through save and load: a fresh
    trainer restored from it takes the same next step as the original
    (table, optimizer moments and schedule position all carried)."""
    lm = toy_labelmap(2, 3)
    splits = split_edges(label_graph_from_paths(lm.leaf_paths(), lm),
                         proportion_of_nb_edges_in_train=0.5, seed=0)
    cfg = EmbeddingTrainerConfig(energy=energy, optimizer=optimizer,
                                 embedding_dim=4, batch_size=4, lr=0.01,
                                 lr_steps=(1,), device="cpu")
    a = EmbeddingTrainer(lm, splits, cfg)
    a.train_epoch(np.random.RandomState(0))
    a.optimal_threshold = 0.25
    ckpt = texp.Checkpointer(texp.ExperimentDir(str(tmp_path), "s"))
    ckpt.save(0, dict(a.checkpoint_payload(), best_f1=0.1, best_epoch=0.0))
    b = EmbeddingTrainer(lm, splits, dataclasses.replace(cfg, seed=5))
    payload = ckpt.load(0, b.checkpoint_payload())
    assert set(payload) == {"params", "opt_state", "optimal_threshold"}
    b.restore_payload(payload)
    assert b.optimal_threshold == 0.25
    assert b.scheduler.last_epoch == a.scheduler.last_epoch
    edges = splits.train[:4]
    nf, nt = edges[[1, 2, 3, 0]].T
    la = a.train_step(edges[:, 0], edges[:, 1], nf, nt)[0]
    lb = b.train_step(edges[:, 0], edges[:, 1], nf, nt)[0]
    assert torch.equal(la, lb)
    assert torch.equal(a.model.embedding, b.model.embedding)


# ----------------------------------------------------------------------
# metrics logger
# ----------------------------------------------------------------------
def test_metrics_logger_jsonl_records(tmp_path, monkeypatch):
    # without tensorboard (its import pulls in TensorFlow): the jsonl
    # mirror alone
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    exp = texp.ExperimentDir(str(tmp_path), "log")
    logger = texp.MetricsLogger(exp)
    logger.scalar("epoch_time", 1.5, 0)
    logger.scalars("val", {"f1": torch.tensor(0.25), "threshold": 2}, 3)
    logger.close()
    recs = [json.loads(l) for l in open(os.path.join(exp.logs,
                                                     "metrics.jsonl"))]
    assert [(r["tag"], r["value"], r["step"]) for r in recs] == [
        ("epoch_time", 1.5, 0), ("val/f1", 0.25, 3), ("val/threshold", 2.0,
                                                       3)]
    assert all(isinstance(r["t"], float) for r in recs)


# ----------------------------------------------------------------------
# JAX checkpoints carried over
# ----------------------------------------------------------------------
def test_label_table_from_jax_checkpoint_trees():
    """The numpy trees of a JAX label-only and a joint checkpoint: the
    table and the threshold (NaN means none)."""
    table = np.random.RandomState(0).randn(7, 4).astype(np.float32)
    label_only = {"params": {"params": {"embedding": table}},
                  "opt_state": [{"mu": table}], "optimal_threshold": 0.3,
                  "best_f1": 0.5, "best_epoch": 2.0}
    joint = {"params": {"labels": {"params": {"embedding": table}},
                        "images": {"trunk": {}}},
             "batch_stats": {}, "optimal_threshold": float("nan")}
    sd, thr = label_table_from_jax_checkpoint(label_only)
    assert torch.equal(sd["embedding"], torch.from_numpy(table))
    assert thr == pytest.approx(0.3, abs=0)
    sd, thr = label_table_from_jax_checkpoint(joint)
    assert torch.equal(sd["embedding"], torch.from_numpy(table))
    assert thr is None
