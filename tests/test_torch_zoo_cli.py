"""The classifier and fc7 CLIs with the zoo's options against the JAX CLIs
on the CPU: ``ethec_experiments --bn_stats_rows 2 --bn_stats_dtype
bfloat16`` (the flags raised before this slice), ``fashion_mnist`` and
``cifar --bn_stats_rows 2`` (their only BatchNorm flag, as in the JAX
CLIs), ``image_emb --model alexnet`` (the reference's fc7 extractor:
4096-wide features), and the joint ``--use_CNN`` path with the two new
backbones.

Runs are compared by what does not depend on the summation order of a
bfloat16 trunk: the files written, the manifest's keys and values, the
result's and the metrics' keys, the score dumps' shapes, finite metrics.
The AlexNet features are compared in float32, from the JAX CLI's seeded
random trunk carried into a port checkpoint: within rtol 1e-4, atol 1e-5
(conv sums in another order).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from learning_embeddings_tpu.cli import cifar as j_cifar
from learning_embeddings_tpu.cli import ethec_experiments as j_ethec
from learning_embeddings_tpu.cli import fashion_mnist as j_fmnist
from learning_embeddings_tpu.cli import image_emb as j_emb
from learning_embeddings_tpu.models.resnet import BACKBONES as JAX_BACKBONES
from learning_embeddings_tpu_torch.cli import cifar as t_cifar
from learning_embeddings_tpu_torch.cli import ethec_experiments as t_ethec
from learning_embeddings_tpu_torch.cli import fashion_mnist as t_fmnist
from learning_embeddings_tpu_torch.cli import image_emb as t_emb
from learning_embeddings_tpu_torch.cli import oe_h as t_oe_h
from learning_embeddings_tpu_torch.models import resnet as tresnet
from learning_embeddings_tpu_torch.models import state_dict_from_jax
from learning_embeddings_tpu_torch.ops import bn
from learning_embeddings_tpu_torch.train.experiment import (Checkpointer,
                                                            ExperimentDir,
                                                            read_manifest)
from test_torch_ethec_cli import (_argv, _tree,  # noqa: F401
                                  native_cpu_convs, png_split)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The runners also log to tensorboard where it imports; that import
    pulls in TensorFlow (~15 s), so these tests keep to the jsonl mirror."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _tags(root):
    with open(os.path.join(root, "logs", "metrics.jsonl")) as f:
        return {json.loads(line)["tag"] for line in f}


def _ghost_layers(monkeypatch):
    """Counts the GhostBatchNorm forwards of the port's runs."""
    seen = []
    fwd = bn.GhostBatchNorm._train

    def counted(self, x):
        seen.append((self.stats_rows, self.stats_dtype))
        return fwd(self, x)
    monkeypatch.setattr(bn.GhostBatchNorm, "_train", counted)
    return seen


def _compare_runs(proot, jroot, port, jax_res):
    assert set(port) == set(jax_res) | {"thresholds", "train_steps"}
    assert set(port["test_metrics"]) == set(jax_res["test_metrics"])
    assert all(np.isfinite(v) for v in port["test_metrics"].values())
    pm = read_manifest(os.path.join(proot, "config_params.txt"))
    jm = read_manifest(os.path.join(jroot, "config_params.txt"))
    assert {k: v for k, v in pm.items()
            if k not in ("device", "loader", "experiment_dir",
                         "experiment_name", "git_commit", "data_root")} == \
        {k: v for k, v in jm.items()
         if k not in ("experiment_dir", "experiment_name", "git_commit",
                      "data_root")}
    assert _tags(proot) == _tags(jroot) | {
        "epoch_time_data_wait", "epoch_time_eval", "epoch_time_checkpoint"}
    assert sorted(os.listdir(os.path.join(proot, "weights"))) == \
        sorted(os.listdir(os.path.join(jroot, "weights")))
    for dump in ("predicted_scores.npy", "correct_labels.npy"):
        p = np.load(os.path.join(proot, "stats", dump))
        j = np.load(os.path.join(jroot, "stats", dump))
        assert p.shape == j.shape and p.dtype == j.dtype, dump
    return pm


def test_ethec_cli_ghost_bf16_statistics_like_jax(png_split, tmp_path,
                                                  native_cpu_convs,
                                                  monkeypatch):
    data, images = png_split
    flags = ["--n_epochs", "1", "--set_mode", "train", "--bn_stats_rows",
             "2", "--bn_stats_dtype", "bfloat16"]
    seen = _ghost_layers(monkeypatch)
    port = t_ethec.main(_argv(data, images, str(tmp_path / "port"), *flags,
                              "--device", "cpu"))
    jax_res = j_ethec.main(_argv(data, images, str(tmp_path / "jax"),
                                 *flags))
    pm = _compare_runs(str(tmp_path / "port" / "e"),
                       str(tmp_path / "jax" / "e"), port, jax_res)
    assert (pm["bn_stats_rows"], pm["bn_stats_dtype"]) == ("2", "bfloat16")
    # every train step's 20 BatchNorms take the ghost bf16 route
    assert len(seen) == 20 * port["train_steps"] > 0
    assert set(seen) == {(2, torch.bfloat16)}


@pytest.mark.parametrize("name,extra", [
    ("fashion_mnist", []), ("cifar", ["--dataset", "cifar10"])],
    ids=["fmnist", "cifar10"])
def test_array_cli_ghost_statistics_like_jax(tmp_path, native_cpu_convs,
                                             monkeypatch, name, extra):
    jmod, tmod = {"fashion_mnist": (j_fmnist, t_fmnist),
                  "cifar": (j_cifar, t_cifar)}[name]

    def argv(side):
        return ["--experiment_dir", str(tmp_path), "--experiment_name", side,
                "--n_epochs", "1", "--loss", "multi_level", "--set_mode",
                "train", "--debug", "--image_size", "16", "--batch_size",
                "32", "--n_workers", "2", "--data_root",
                str(tmp_path / "no_data"), "--bn_stats_rows", "2", *extra]
    seen = _ghost_layers(monkeypatch)
    port = tmod.main(argv("port") + ["--device", "cpu"])
    jax_res = jmod.main(argv("jax"))
    pm = _compare_runs(str(tmp_path / "port"), str(tmp_path / "jax"), port,
                       jax_res)
    assert pm["bn_stats_rows"] == "2"
    assert len(seen) == 20 * port["train_steps"] > 0
    assert set(seen) == {(2, torch.float32)}


def test_image_emb_alexnet_features_like_jax(png_split, tmp_path,
                                             monkeypatch):
    """The JAX CLI's seeded random AlexNet, carried into a port classifier
    checkpoint; both CLIs in float32."""
    data, images = png_split
    f32 = {k: (lambda f: lambda **kw: f(**{**kw, "dtype": jnp.float32}))(f)
           for k, f in JAX_BACKBONES.items()}
    monkeypatch.setattr(j_emb, "BACKBONES", f32)
    monkeypatch.setitem(tresnet.BACKBONES, "alexnet",
                        lambda **kw: tresnet.AlexNet(
                            **{**kw, "dtype": torch.float32}))
    trunk = f32["alexnet"](num_classes=None, features_only=True)
    variables = trunk.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 64, 64, 3), jnp.float32),
                           train=False)
    sd = state_dict_from_jax({"trunk": jax.device_get(variables["params"])},
                             {})
    exp = ExperimentDir(str(tmp_path), "cls")
    Checkpointer(exp).save("best_model", {"params": sd, "batch_stats": {}})
    common = ["--data_dir", data, "--image_dir", images, "--model",
              "alexnet", "--image_size", "64", "--batch_size", "4",
              "--n_workers", "2"]
    written = t_emb.main(common + ["--output_dir", str(tmp_path / "p"),
                                   "--experiment_load_dir", exp.root,
                                   "--device", "cpu"])
    j_emb.main(common + ["--output_dir", str(tmp_path / "j")])
    assert sorted(written) == ["test", "train", "val"]
    for split in written:
        with np.load(tmp_path / "p" / f"{split}.npz") as p, \
                np.load(tmp_path / "j" / f"{split}.npz") as j:
            assert p["features"].shape == j["features"].shape
            assert p["features"].shape[1] == 4096
            assert p["features"].dtype == np.float32
            np.testing.assert_array_equal(p["paths"], j["paths"])
            np.testing.assert_allclose(p["features"], j["features"],
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("model,size", [("alexnet", 64), ("vgg11_bn", 32)],
                         ids=["alexnet", "vgg11_bn"])
def test_joint_use_cnn_runs_the_new_backbones(png_split, tmp_path,
                                              native_cpu_convs, model, size):
    # AlexNet's 11/4 stem and three 3/2 pools need 63² at least
    data, images = png_split
    res = t_oe_h.main(["--use_CNN", "--model", model, "--data_dir", data,
                       "--image_dir", images, "--image_size", str(size),
                       "--batch_size", "8", "--n_epochs", "1",
                       "--set_mode", "train", "--experiment_dir",
                       str(tmp_path), "--experiment_name", "j",
                       "--eval_max_images", "4", "--device", "cpu"])
    manifest = read_manifest(str(tmp_path / "j" / "config_params.txt"))
    assert manifest["model"] == model and manifest["use_CNN"] == "True"
    trunk = res["trainer"].featcnn.trunk
    assert type(trunk) is tresnet.BACKBONES[model]
    assert np.isfinite(res["reconstruction_f1"])
    assert all(np.isfinite(v) for v in res["test_metrics"].values())
