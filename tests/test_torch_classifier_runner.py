"""The port's classifier experiment (``train/runner.py::run_classifier``)
against the JAX package's on the CPU: the same PNG split, the same
weighted-resampled epoch orders and crops (numpy ``RandomState``), and
both trainers started from the same weights (the JAX trainer's
initialisation, carried over with ``state_dict_from_jax`` by patching the
port runner's trainer construction). Both run a float32 ResNet-18 at 32²
with the fused-reduction BatchNorm (the JAX side's ``bn_impl='pallas'``
as its own tests run it here), lr 1e-5, on one device.

Tolerances: per-epoch train loss rel 1e-4; the final test scores
(``predicted_scores.npy``) within 1e-3 of their largest entry; checkpoint
epochs, best epoch, the resumed run's epochs and ``correct_labels.npy``
equal; a ``--set_mode test`` run scores the best model and, like the JAX
runner, reports best epoch -1. The ``bottleneck2d`` head writes its per-eval plot; ``--profile`` writes a
trace whose summary counts device time only (none on the CPU).
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from learning_embeddings_tpu import data as jdata
from learning_embeddings_tpu.hierarchy import (
    labelmap_from_records as jax_labelmap_from_records)
from learning_embeddings_tpu.train import runner as jrunner
from learning_embeddings_tpu.train.classifier import (
    ClassifierConfig as JaxConfig, ClassifierTrainer as JaxTrainer)
from learning_embeddings_tpu.train.experiment import (
    Checkpointer as JaxCheckpointer, ExperimentDir as JaxExperimentDir)
from learning_embeddings_tpu_torch import data as tdata
from learning_embeddings_tpu_torch.hierarchy import labelmap_from_records
from learning_embeddings_tpu_torch.models import state_dict_from_jax
from learning_embeddings_tpu_torch.train import classifier as tclassifier
from learning_embeddings_tpu_torch.train.classifier import ClassifierConfig
from learning_embeddings_tpu_torch.train.experiment import (Checkpointer,
                                                            ExperimentDir)
from learning_embeddings_tpu_torch.train.runner import run_classifier
from learning_embeddings_tpu_torch.utils.profiling import summarize_trace

torch.set_num_threads(2)

SIZE, BATCH, LR = 32, 8, 1e-5
STAGES18 = (2, 2, 2, 2)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The port's logger also writes tensorboard where it imports; that
    import pulls in TensorFlow (~15 s), so these tests keep to the jsonl
    mirror, which holds the same records."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _records():
    """Four genera of two species each: 6 records a species."""
    recs = []
    for sp in range(8):
        g = sp // 2
        for k in range(6):
            i = len(recs)
            recs.append({"token": f"t{i:03d}", "family": f"F{g // 2}",
                         "subfamily": f"S{g // 2}", "genus": f"G{g}",
                         "specific_epithet": f"e{sp % 2}",
                         "image_path": f"d{g}",
                         "image_name": f"i{i:03d}.png"})
    return recs


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A 32/8/8 split of 48 records over 8 species, one 40×48 PNG each;
    the port's and the JAX package's labelmaps and datasets."""
    from PIL import Image

    root = tmp_path_factory.mktemp("cls")
    recs = _records()
    rng = np.random.RandomState(0)
    for r in recs:
        d = root / "images" / r["image_path"]
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.randint(0, 256, (40, 48, 3)).astype(
            np.uint8)).save(str(d / r["image_name"]))
    parts = {"train": [], "val": [], "test": []}
    for i, r in enumerate(recs):     # 4 train, 1 val, 1 test a species
        parts["train" if i % 6 < 4 else "val" if i % 6 == 4
              else "test"].append(r)
    lm = labelmap_from_records(recs)
    jlm = jax_labelmap_from_records(recs)
    ds = {s: tdata.encode_records(rs, lm) for s, rs in parts.items()}
    jds = {s: jdata.encode_records(rs, jlm) for s, rs in parts.items()}
    return str(root / "images"), lm, ds, jlm, jds


def _configs(**kw):
    common = dict(backbone="resnet18", lr=LR, image_size=SIZE,
                  batch_size=BATCH, seed=0, **kw)
    return (JaxConfig(dtype=jnp.float32, bn_impl="pallas", donate=False,
                      **common),
            ClassifierConfig(dtype=torch.float32, device="cpu", **common))


def _same_start(monkeypatch, jcfg, jlm):
    """The port runner's trainer starts from the weights the JAX runner's
    trainer gets from the same config (its init is seeded)."""
    jtr = JaxTrainer(jlm, jcfg)
    start = state_dict_from_jax(jax.device_get(jtr.state.params),
                                jax.device_get(jtr.state.batch_stats),
                                STAGES18)

    class FromJax(tclassifier.ClassifierTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.model.load_state_dict(start, strict=True)

    monkeypatch.setattr(tclassifier, "ClassifierTrainer", FromJax)


def _metrics(exp_root):
    with open(os.path.join(exp_root, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(split, tmp_path_factory):
    """Both runners: 2 epochs, then --resume to 3, then --set_mode test."""
    images, lm, ds, jlm, jds = split
    root = tmp_path_factory.mktemp("runs")
    jcfg, cfg = _configs()
    out = {"port": {}, "jax": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        _same_start(mp, jcfg, jlm)
        for tag, kw in (("train", dict(n_epochs=2)),
                        ("resume", dict(n_epochs=3, resume=True)),
                        ("test", dict(n_epochs=3, set_mode="test"))):
            common = dict(experiment_name="e", n_workers=2, **kw)
            out["port"][tag] = run_classifier(
                lm, ds, images, cfg, experiment_dir=str(root / "port"),
                **common)
            out["jax"][tag] = jrunner.run_classifier(
                jlm, jds, images, jcfg, experiment_dir=str(root / "jax"),
                mesh=None, **common)
            for side in ("port", "jax"):
                stats = out[side][tag]["experiment"].stats
                out[side][tag + "_scores"] = np.load(
                    os.path.join(stats, "predicted_scores.npy"))
                out[side][tag + "_labels"] = np.load(
                    os.path.join(stats, "correct_labels.npy"))
    out["root"] = root
    return out


def test_train_losses_match_jax(runs):
    port, jax_losses = (
        {r["step"]: r["value"] for r in _metrics(str(runs["root"] / side
                                                     / "e"))
         if r["tag"] == "train/loss"} for side in ("port", "jax"))
    assert sorted(port) == sorted(jax_losses) == [0, 1, 2]
    # the 2-epoch run within 1e-4; the resumed third epoch within 5e-4:
    # after an Adam step, weights whose gradient is at rounding level move
    # by ±lr on either side, and the loss gap grows ~10× an epoch (1e-6,
    # 1e-5, 1e-4 here). (The resumed epoch cannot be held to an
    # uninterrupted run: both runners draw a resumed run's order from a
    # fresh RandomState(seed).)
    for epoch, rel in ((0, 1e-4), (1, 1e-4), (2, 5e-4)):
        assert abs(port[epoch] - jax_losses[epoch]) <= \
            rel * abs(jax_losses[epoch]), epoch


def test_checkpoints_best_epoch_and_resume_match_jax(runs):
    port = Checkpointer(ExperimentDir(str(runs["root"] / "port"), "e"))
    jck = JaxCheckpointer(JaxExperimentDir(str(runs["root"] / "jax"), "e"))
    assert port.epochs_on_disk() == jck.epochs_on_disk() == [0, 1, 2]
    assert "best_model" in os.listdir(port.dir)
    for tag in ("train", "resume"):
        p, j = runs["port"][tag], runs["jax"][tag]
        assert p["best_epoch"] == j["best_epoch"], tag
        assert abs(p["best_val_score"] - j["best_val_score"]) <= 1e-6, tag
    # the resumed run trained epoch 2 only, once
    steps = [r["step"] for r in _metrics(str(runs["root"] / "port" / "e"))
             if r["tag"] == "train/loss"]
    assert steps == [0, 1, 2]
    # the test-mode run restores only the best model's weights, as the
    # JAX runner does; the checkpoint keeps the epoch it was taken at
    assert runs["port"]["test"]["best_epoch"] == \
        runs["jax"]["test"]["best_epoch"] == -1
    assert int(port.load_raw("best_model")["best_epoch"]) == \
        runs["port"]["resume"]["best_epoch"]
    # the train steps each call took: 4 a epoch (32 images, batch 8)
    assert [runs["port"][t]["train_steps"]
            for t in ("train", "resume", "test")] == [8, 4, 0]


@pytest.mark.parametrize("tag", ["train", "resume", "test"])
def test_score_dumps_match_jax(runs, tag):
    p, j = runs["port"][tag + "_scores"], runs["jax"][tag + "_scores"]
    assert p.shape == j.shape == (8, 2 + 2 + 4 + 8)
    assert np.abs(p - j).max() <= 1e-3 * np.abs(j).max()
    np.testing.assert_array_equal(runs["port"][tag + "_labels"],
                                  runs["jax"][tag + "_labels"])
    assert runs["port"][tag]["test_metrics"].keys() == \
        runs["jax"][tag]["test_metrics"].keys()


def test_metric_tags_cover_the_jax_runners(runs):
    port = {r["tag"] for r in _metrics(str(runs["root"] / "port" / "e"))}
    assert {"train/loss", "val/micro_f1", "test/micro_f1",
            "best_test/micro_f1", "epoch_time", "epoch_time_train",
            "epoch_time_data_wait", "epoch_time_eval",
            "epoch_time_checkpoint"} <= port
    best = runs["port"]["resume"]["best_epoch"]
    for d in ("val0", "test1", "val2", f"best_test{best}"):
        assert os.path.isfile(runs["root"] / "port" / "e" / "stats" / d
                              / "summary.md"), d


def test_multi_label_ml_evaluator_matches_jax(split, tmp_path, monkeypatch):
    """multi_label_sm with the ML evaluator: per-class thresholds tuned on
    val, recalibrated after the best reload; the same loss and scores."""
    images, lm, ds, jlm, jds = split
    jcfg, cfg = _configs(criterion="multi_label_sm")
    _same_start(monkeypatch, jcfg, jlm)
    common = dict(experiment_name="ml", n_workers=2, n_epochs=1,
                  evaluator="ML")
    p = run_classifier(lm, ds, images, cfg,
                       experiment_dir=str(tmp_path / "p"), **common)
    j = jrunner.run_classifier(jlm, jds, images, jcfg,
                               experiment_dir=str(tmp_path / "j"),
                               mesh=None, **common)
    assert p["best_epoch"] == j["best_epoch"] == 0
    # the thresholds the final test pass used, tuned on val after the
    # best reload
    assert p["thresholds"].shape == (lm.n_classes,)
    assert np.isfinite(p["thresholds"]).all()
    assert 0.0 <= p["test_metrics"]["mAP"] <= 1.0
    assert abs(p["test_metrics"]["mAP"] - j["test_metrics"]["mAP"]) <= 1e-3
    tags = {r["tag"] for r in _metrics(str(tmp_path / "p" / "ml"))}
    assert "best_val/micro_f1" in tags
    ps = np.load(tmp_path / "p" / "ml" / "stats" / "predicted_scores.npy")
    js = np.load(tmp_path / "j" / "ml" / "stats" / "predicted_scores.npy")
    assert np.abs(ps - js).max() <= 1e-3 * np.abs(js).max()


def test_bottleneck2d_plots_and_profile(split, tmp_path):
    images, lm, ds, _, _ = split
    _, cfg = _configs(head_override="bottleneck2d")
    res = run_classifier(lm, ds, images, cfg, experiment_dir=str(tmp_path),
                         experiment_name="b2d", n_epochs=1, n_workers=2,
                         profile_steps=1, generate_plots=True)
    stats = res["experiment"].stats
    assert {"label_reps_val0.png", "label_reps_test0.png",
            "label_reps_best_test0.png"} <= set(os.listdir(stats))
    assert os.path.isfile(os.path.join(stats, "f1_vs_train_freq.png"))
    assert os.listdir(os.path.join(stats, "pr_curves"))
    # the trace holds host events only on the CPU: no device time
    assert os.path.isfile(os.path.join(stats, "trace", "trace.json"))
    assert summarize_trace(os.path.join(stats, "trace")) == []


def test_unported_runner_options_raise(split, tmp_path):
    """Without a process group a tensor-parallel head has no ranks to
    shard over and raises the JAX mesh error, where the JAX runner would
    quietly train on one device; a mesh that is no parallel.mesh.Mesh
    raises (meshed runs: tests/test_torch_mesh_runner.py)."""
    images, lm, ds, _, _ = split
    _, cfg = _configs()
    for kw, err, match in ((dict(n_model=2), ValueError,
                            r"does not fit the 1 available device\(s\)"),
                           (dict(mesh="data"), TypeError,
                            "parallel.mesh.Mesh")):
        with pytest.raises(err, match=match):
            run_classifier(lm, ds, images, cfg,
                           experiment_dir=str(tmp_path), experiment_name="x",
                           n_epochs=1, **kw)


def test_summarize_trace_counts_device_time_only(tmp_path):
    """A chrome trace as torch.profiler writes it on a card: kernels and
    copies count, host ops and annotated ranges do not."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "bn_stats_kernel", "dur": 300},
        {"ph": "X", "cat": "kernel", "name": "bn_stats_kernel", "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 100},
        {"ph": "X", "cat": "gpu_user_annotation",
         "name": "Optimizer.step#Adam.step", "dur": 5000},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "dur": 9000},
    ]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    got = summarize_trace(str(tmp_path), n_steps=2)
    assert got == [("bn_stats_kernel", 0.2, 0.8), ("Memcpy HtoD", 0.05, 0.2)]
