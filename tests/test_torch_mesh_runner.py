"""The runners and CLIs on a mesh of gloo ranks on the CPU, and the twin
of ``dryrun_multichip``:

* ``run_classifier`` on a (2, 2) mesh (batch over 'data', the head over
  'model') with eval splits that leave a ragged tail batch (padded to the
  batch, the padding dropped): its test scores equal the one-device run's
  (within 1e-3 of their largest entry, the classifier runner test's
  tolerance), rank 0 alone wrote the manifest, the metrics and the
  checkpoints; a one-device ``--set_mode test`` run scores the mesh run's
  checkpoint (the head whole in it) as the mesh run did, and a meshed
  ``--resume`` continues from a one-device checkpoint;
* ``cli/ethec_experiments.py --n_model 2`` in ranks (the label CLI under
  ``torchrun``: ``test_torch_mesh_joint.py``);
* ``entry.dryrun_multichip(4, device="cpu")`` ends in ``DRYRUN_SUMMARY``
  with ``"ok": true``."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from learning_embeddings_tpu_torch import data as tdata
from learning_embeddings_tpu_torch.entry import dryrun_multichip
from learning_embeddings_tpu_torch.hierarchy import labelmap_from_records
from learning_embeddings_tpu_torch.parallel.launch import run_ranks
from learning_embeddings_tpu_torch.train.classifier import ClassifierConfig
from learning_embeddings_tpu_torch.train.runner import run_classifier

from test_torch_classifier_runner import _records
from test_torch_ethec_cli import _argv, png_split  # noqa: F401

torch.set_num_threads(2)
PROGRAMS = "learning_embeddings_tpu_torch.parallel.programs:"


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture
def emptied(tmp_path):
    """tmp_path, emptied at the end: the experiments' ResNet-18
    checkpoints take ~130 MB each, and pytest keeps its last runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """32/8/8 records over 8 species, one 40×48 PNG each."""
    from PIL import Image

    root = tmp_path_factory.mktemp("mesh_cls")
    recs = _records()
    rng = np.random.RandomState(0)
    for r in recs:
        d = root / "images" / r["image_path"]
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.randint(0, 256, (40, 48, 3)).astype(
            np.uint8)).save(str(d / r["image_name"]))
    parts = {"train": [], "val": [], "test": []}
    for i, r in enumerate(recs):
        parts["train" if i % 6 < 4 else "val" if i % 6 == 4
              else "test"].append(r)
    lm = labelmap_from_records(recs)
    ds = {s: tdata.encode_records(rs, lm) for s, rs in parts.items()}
    return str(root / "images"), lm, ds


def _lines(exp):
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]


def test_run_classifier_on_a_mesh(split, emptied):
    tmp_path = emptied
    images, lm, ds = split
    # batch 6: each 8-image eval split is a batch of 6 and a tail of 2
    cfg = ClassifierConfig(backbone="resnet18", lr=1e-5, image_size=32,
                           batch_size=6, seed=0, dtype=torch.float32,
                           device="cpu")
    common = dict(labelmap=lm, datasets=ds, image_root=images, cfg=cfg,
                  experiment_dir=str(tmp_path), n_epochs=1, n_workers=2)
    one = run_classifier(experiment_name="one", mesh=None, **common)
    res = run_ranks(PROGRAMS + "runner_run", 4,
                    dict(runner="run_classifier", n_data=2, n_model=2,
                         experiment_name="mesh", jsonl_only=True,
                         keep=("test_metrics", "best_epoch", "train_steps",
                               "best_val_score"), **common),
                    workdir=str(tmp_path / "ranks"), threads=1,
                    timeout_s=240)
    mesh_exp = str(tmp_path / "mesh")
    one_exp = str(tmp_path / "one")
    for r in res:
        assert r == res[0]
        assert r["best_epoch"] == one["best_epoch"] == 0
        assert r["train_steps"] == one["train_steps"] == 32 // 6
        for k, v in one["test_metrics"].items():
            assert r["test_metrics"][k] == pytest.approx(v, abs=1e-6), k
    got = np.load(os.path.join(mesh_exp, "stats", "predicted_scores.npy"))
    want = np.load(os.path.join(one_exp, "stats", "predicted_scores.npy"))
    assert got.shape == want.shape == (8, lm.n_classes)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-3 * np.abs(want).max())
    # rank 0 alone wrote: the same records as the one-device run
    assert sorted(os.listdir(os.path.join(mesh_exp, "weights"))) == \
        sorted(os.listdir(os.path.join(one_exp, "weights"))) == \
        ["0", "best_model"]
    mine, theirs = _lines(mesh_exp), _lines(one_exp)
    assert [(x["tag"], x["step"]) for x in mine] == \
        [(x["tag"], x["step"]) for x in theirs]

    # a one-device run scores the mesh run's checkpoint as the mesh did
    test = run_classifier(experiment_name="mesh", mesh=None,
                          set_mode="test", **common)
    for k, v in res[0]["test_metrics"].items():
        assert test["test_metrics"][k] == pytest.approx(v, abs=1e-6), k
    # a meshed resume continues from the one-device checkpoint
    res = run_ranks(PROGRAMS + "runner_run", 4,
                    dict(runner="run_classifier", n_data=2, n_model=2,
                         experiment_name="one", jsonl_only=True,
                         keep=("best_epoch", "train_steps"), resume=True,
                         **dict(common, n_epochs=2)),
                    workdir=str(tmp_path / "ranks2"), threads=1,
                    timeout_s=240)
    assert res[0]["train_steps"] == 32 // 6      # epoch 1 only
    assert sorted(os.listdir(os.path.join(one_exp, "weights"))) == \
        ["0", "1", "best_model"]
    assert [x["step"] for x in _lines(one_exp)
            if x["tag"] == "train/loss"] == [0, 1]


def test_classifier_cli_with_n_model_2_in_ranks(png_split, emptied):
    tmp_path = emptied
    data, images = png_split
    argv = _argv(data, images, str(tmp_path), "--n_epochs", "1",
                 "--set_mode", "train", "--device", "cpu", "--n_model", "2")
    res = run_ranks(PROGRAMS + "cli_main", 2,
                    dict(module="learning_embeddings_tpu_torch.cli."
                         "ethec_experiments", argv=argv, jsonl_only=True,
                         mkldnn=False,
                         keep=("best_epoch", "train_steps", "test_metrics")),
                    workdir=str(tmp_path / "ranks"), threads=1,
                    timeout_s=240)
    assert res[0] == res[1]
    assert res[0]["best_epoch"] == 0 and res[0]["train_steps"] >= 1
    exp = tmp_path / "e"
    for rel in ("config_params.txt", "weights/0", "weights/best_model",
                "stats/predicted_scores.npy"):
        assert (exp / rel).is_file(), rel
    assert "n_model: 2" in (exp / "config_params.txt").read_text()
    # the checkpoint holds the head whole
    head = torch.load(str(exp / "weights" / "0"), weights_only=True)[
        "params"]["fc.weight"]
    assert head.shape[1] == 512


def test_dryrun_multichip_on_the_cpu(capsys):
    out = dryrun_multichip(4, device="cpu", threads=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("DRYRUN_SUMMARY ")
    summary = json.loads(lines[-1][len("DRYRUN_SUMMARY "):])
    assert summary == out and summary["ok"] is True
    assert summary["mesh"] == {"data": 2, "model": 2}
    assert summary["eval_meshed"]["joint_cnn_rows"] == [11, 4]
    assert summary["eval_meshed"]["joint_fc7_rows"] == [5, 4]
    for k in ("classifier", "grad_accum", "spatial_grad_accum", "joint",
              "joint_cnn", "joint_cnn_tower_warm", "label_embedding"):
        assert np.isfinite(summary[k]), k
    # JAX's stage: spatial + grad_accum=2, ResNet-18@64, on (n/2, 2): the
    # grad_accum stage's function on the same batch (bf16 trunks), with
    # 18 forward and 17 backward halo exchanges a micro-step (the stem,
    # the pool and 16 3×3 convs; the image takes no gradient)
    assert "spatial_partition" not in summary
    assert abs(summary["spatial_grad_accum"] - summary["grad_accum"]) <= \
        1e-2 * abs(summary["grad_accum"])
    assert summary["spatial_halos"] == {"halo": 2 * 18, "halo_grad": 2 * 17}
