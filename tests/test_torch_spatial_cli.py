"""``cli/ethec_experiments.py --spatial_partition --n_model 2`` in two
gloo ranks on the CPU (as under ``torchrun``): the run shards the images'
H over the two ranks (``run_classifier``'s ``mesh="auto"``), both ranks
return the same result, rank 0 writes the experiment, whose manifest
records the flag and whose checkpoint holds the head whole, and its test
scores equal the one-device run's within 5e-2 of their largest entry (the
bfloat16 trunk's rounding, at 16²)."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from learning_embeddings_tpu_torch.cli import ethec_experiments as t_ethec
from learning_embeddings_tpu_torch.parallel.launch import run_ranks

from test_torch_ethec_cli import _argv, png_split  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture
def emptied(tmp_path, monkeypatch):
    """tmp_path, emptied at the end (each experiment keeps ResNet-18
    checkpoints); no tensorboard (its import pulls in TensorFlow) and
    oneDNN off for the bfloat16 trunk at 16² (``onednn_dw_repro.py``)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_classifier_cli_with_spatial_partition_in_ranks(png_split, emptied):
    tmp_path = emptied
    data, images = png_split
    flags = ("--n_epochs", "1", "--set_mode", "train", "--device", "cpu")
    argv = _argv(data, images, str(tmp_path / "mesh"), *flags,
                 "--spatial_partition", "--n_model", "2")
    res = run_ranks("learning_embeddings_tpu_torch.parallel.programs:"
                    "cli_main", 2,
                    dict(module="learning_embeddings_tpu_torch.cli."
                         "ethec_experiments", argv=argv, jsonl_only=True,
                         mkldnn=False,
                         keep=("best_epoch", "train_steps", "test_metrics")),
                    workdir=str(tmp_path / "ranks"), threads=1,
                    timeout_s=240)
    assert res[0] == res[1]
    assert res[0]["best_epoch"] == 0 and res[0]["train_steps"] >= 1
    assert all(np.isfinite(v) for v in res[0]["test_metrics"].values())
    exp = tmp_path / "mesh" / "e"
    manifest = (exp / "config_params.txt").read_text()
    assert "spatial_partition: True" in manifest and "n_model: 2" in manifest
    head = torch.load(str(exp / "weights" / "0"), weights_only=True)[
        "params"]["fc.weight"]
    assert head.shape[1] == 512
    one = t_ethec.main(_argv(data, images, str(tmp_path / "one"), *flags))
    assert one["train_steps"] == res[0]["train_steps"]
    got, want = (np.load(os.path.join(root, "e", "stats",
                                      "predicted_scores.npy"))
                 for root in (tmp_path / "mesh", tmp_path / "one"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-2 * np.abs(want).max())
