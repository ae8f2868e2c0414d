"""The port's CIFAR / FashionMNIST workloads (``data/workloads.py``, a numpy
copy) and their CLIs (``cli/fashion_mnist.py``, ``cli/cifar.py``) against
the JAX package's, on the CPU.

* Bit for bit: the three taxonomies, ``synthetic_array_dataset``,
  ``stratified_index_split``, the file loaders on files the tests write,
  and ``ImagePipeline``'s uint8 batches over an ``ArrayDataset`` with the
  RandomResizedCrop transform (the in-memory branch).
* The CLIs: the JAX flags plus ``--device``; one epoch on the synthetic
  stand-in (``--debug``: 600 images) with ``--device cpu`` beside the JAX
  CLI on the same arguments: the manifest's keys, the ``metrics.jsonl``
  tags, the checkpoint names, the report directories, the score dumps'
  shapes and the result's keys (the JAX CLI runs flax's BatchNorm, the
  port its fused reductions, so the numbers are not compared). The
  unported flags raise naming their ROADMAP item; without a card and
  without ``--device cpu`` the CLIs raise.
"""

import gzip
import json
import os
import pickle
import struct
import sys

import numpy as np
import pytest
import torch

from learning_embeddings_tpu.cli import cifar as j_cifar
from learning_embeddings_tpu.cli import fashion_mnist as j_fmnist
from learning_embeddings_tpu.data import pipeline as jpipeline
from learning_embeddings_tpu.data import workloads as jw
import learning_embeddings_tpu_torch.data as tdata
from learning_embeddings_tpu_torch.cli import cifar as t_cifar
from learning_embeddings_tpu_torch.cli import fashion_mnist as t_fmnist
from learning_embeddings_tpu_torch.data import pipeline as tpipeline
from learning_embeddings_tpu_torch.data import workloads as tw
from learning_embeddings_tpu_torch.train.experiment import read_manifest

torch.set_num_threads(2)

TAXONOMIES = ("cifar10_labelmap", "cifar100_labelmap", "fmnist_labelmap")


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """Both runners also log to tensorboard where it imports; that import
    pulls in TensorFlow (~15 s), so these tests keep to the jsonl mirror."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture
def native_cpu_convs(monkeypatch):
    """The CLIs' trunk runs in bfloat16; at 16² images oneDNN's bfloat16
    weight gradient on an AMX CPU writes NaN into taps that see only
    padding (``onednn_dw_repro.py``); PyTorch's native convolution does
    not."""
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)


@pytest.mark.parametrize("name", TAXONOMIES)
def test_taxonomies_equal_jax(name):
    got, want = getattr(tw, name)(), getattr(jw, name)()
    assert got.levels == want.levels
    assert got.level_names == want.level_names
    assert got.ix_to_name == want.ix_to_name
    np.testing.assert_array_equal(got.leaf_paths(), want.leaf_paths())
    np.testing.assert_array_equal(got.full_child_mask(),
                                  want.full_child_mask())
    assert getattr(tdata, name) is getattr(tw, name)


@pytest.mark.parametrize("n,size,channels,seed", [(600, 28, 1, 0),
                                                  (600, 32, 3, 0),
                                                  (50, 8, 3, 7)])
@pytest.mark.parametrize("name", TAXONOMIES)
def test_synthetic_array_dataset_equals_jax(name, n, size, channels, seed):
    got = tw.synthetic_array_dataset(getattr(tw, name)(), n, size=size,
                                     channels=channels, seed=seed)
    want = jw.synthetic_array_dataset(getattr(jw, name)(), n, size=size,
                                      channels=channels, seed=seed)
    for key in ("images", "leaf_labels", "level_labels"):
        a, b = getattr(got, key), getattr(want, key)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b)
    assert got.image_paths == want.image_paths and len(got) == n
    np.testing.assert_array_equal(got.multihot(got.labelmap),
                                  want.multihot(want.labelmap))


@pytest.mark.parametrize("ratios", [(0.8, 0.1, 0.1), (0.5, 0.25, 0.25)])
@pytest.mark.parametrize("seed", [0, 3])
def test_stratified_index_split_equals_jax(seed, ratios):
    labels = np.random.RandomState(1).randint(0, 10, 613).astype(np.int32)
    got = tw.stratified_index_split(labels, ratios, seed)
    want = jw.stratified_index_split(labels, ratios, seed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert sorted(np.concatenate(got).tolist()) == list(range(613))


# ----------------------------------------------------------------------
# the file loaders, on files written here
# ----------------------------------------------------------------------
def _pickle(path, data, labels_key, labels):
    with open(path, "wb") as f:
        pickle.dump({b"data": data, labels_key: labels}, f)


def _write_cifar10(root, rng, per_batch=6):
    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        _pickle(d / name, rng.randint(0, 256, (per_batch, 3072), np.uint8),
                b"labels", rng.randint(0, 10, per_batch).tolist())


def _write_cifar100(root, rng, n=9):
    d = root / "cifar-100-python"
    d.mkdir(parents=True)
    for name in ("train", "test"):
        _pickle(d / name, rng.randint(0, 256, (n, 3072), np.uint8),
                b"fine_labels", rng.randint(0, 100, n).tolist())


def _idx(path, arr, gz):
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


def _write_fmnist(root, rng, gz, n=7):
    d = root / "FashionMNIST" / "raw"
    d.mkdir(parents=True)
    sfx = ".gz" if gz else ""
    for stem, shape in (("train-images-idx3-ubyte", (n, 28, 28)),
                        ("train-labels-idx1-ubyte", (n,)),
                        ("t10k-images-idx3-ubyte", (n - 2, 28, 28)),
                        ("t10k-labels-idx1-ubyte", (n - 2,))):
        high = 10 if "labels" in stem else 256
        _idx(d / (stem + sfx), rng.randint(0, high, shape), gz)


@pytest.mark.parametrize("loader", ["cifar10", "cifar100", "fmnist_gz",
                                    "fmnist_raw"])
def test_loaders_equal_jax(tmp_path, loader):
    rng = np.random.RandomState(0)
    name = loader.split("_")[0]
    if name == "cifar10":
        _write_cifar10(tmp_path, rng)
    elif name == "cifar100":
        _write_cifar100(tmp_path, rng)
    else:
        _write_fmnist(tmp_path, rng, gz=loader.endswith("gz"))
    got = getattr(tw, f"load_{name}")(str(tmp_path))
    want = getattr(jw, f"load_{name}")(str(tmp_path))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    channels = 1 if name == "fmnist" else 3
    assert got[0].shape[1:] == ((28, 28, 1) if channels == 1
                                else (32, 32, 3))


@pytest.mark.parametrize("name", ["cifar10", "cifar100", "fmnist"])
def test_loaders_raise_without_files(tmp_path, name):
    with pytest.raises(FileNotFoundError):
        getattr(tw, f"load_{name}")(str(tmp_path))


# ----------------------------------------------------------------------
# the pipeline's in-memory branch
# ----------------------------------------------------------------------
@pytest.mark.parametrize("channels,size", [(1, 28), (3, 32)])
@pytest.mark.parametrize("train", [True, False])
def test_array_dataset_batches_equal_jax(channels, size, train):
    """uint8 batches over an ArrayDataset with the RandomResizedCrop
    transform (train) or the eval resize, the same seed: bit-equal."""
    lm_t, lm_j = tw.fmnist_labelmap(), jw.fmnist_labelmap()
    ds_t = tw.synthetic_array_dataset(lm_t, 40, size=size, channels=channels)
    ds_j = jw.synthetic_array_dataset(lm_j, 40, size=size, channels=channels)
    order = np.random.RandomState(2).permutation(40)
    kw = dict(image_size=24, batch_size=8, train=train,
              grayscale=channels == 1, num_workers=2, augment="rrc",
              out_dtype="uint8")
    got = list(tpipeline.ImagePipeline(ds_t, lm_t, "", **kw)
               .batches(order, seed=3))
    want = list(jpipeline.ImagePipeline(ds_j, lm_j, "", **kw)
                .batches(order, seed=3))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g["image"].dtype == w["image"].dtype == np.uint8
        assert g["image"].shape == (8, 24, 24, channels)
        for key in ("image", "level_labels", "leaf_labels", "multihot",
                    "index"):
            np.testing.assert_array_equal(g[key], w[key])


# ----------------------------------------------------------------------
# the CLIs
# ----------------------------------------------------------------------
CLIS = {"fashion_mnist": (j_fmnist, t_fmnist), "cifar": (j_cifar, t_cifar)}


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), type(a).__name__, a.type,
                     a.default, a.nargs, a.choices, a.required)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_parser_has_the_jax_flags_plus_device(name):
    jmod, tmod = CLIS[name]
    want, got = _flags(jmod.build_parser()), _flags(tmod.build_parser())
    assert set(got) == set(want) | {"device"}
    for dest, spec in want.items():
        assert got[dest] == spec, dest
    assert got["device"] == (("--device",), "_StoreAction", str, "cuda",
                             None, None, False)
    assert tmod.LOSS_MAP == jmod.LOSS_MAP


def _argv(exp_dir, name, *extra):
    return ["--experiment_dir", str(exp_dir), "--experiment_name", name,
            "--n_epochs", "1", "--loss", "multi_level", "--set_mode",
            "train", "--debug", "--image_size", "16", "--batch_size", "32",
            "--n_workers", "2", "--data_root", str(exp_dir / "no_data"),
            *extra]


@pytest.mark.parametrize("name,extra", [
    ("fashion_mnist", []), ("cifar", ["--dataset", "cifar10"]),
    ("cifar", ["--dataset", "cifar100"])], ids=["fmnist", "cifar10",
                                                "cifar100"])
def test_cli_runs_one_epoch_like_jax(tmp_path, capsys, native_cpu_convs,
                                     name, extra):
    jmod, tmod = CLIS[name]
    port = tmod.main(_argv(tmp_path, "port", *extra, "--device", "cpu"))
    port_out = capsys.readouterr().out
    jax_res = jmod.main(_argv(tmp_path, "jax", *extra))
    jax_out = capsys.readouterr().out
    stand_in = extra[-1] if extra else "FashionMNIST"
    msg = f"== {stand_in} files not found; using a synthetic stand-in"
    assert msg in port_out and msg in jax_out

    # 600 images, int(0.8 n) of each class's n in train, batches of 32
    lm = getattr(tw, {"FashionMNIST": "fmnist"}.get(stand_in, stand_in)
                 + "_labelmap")()
    labels = tw.synthetic_array_dataset(lm, 600).leaf_labels
    n_train = len(tw.stratified_index_split(labels)[0])
    assert 400 < n_train <= 480
    assert port["train_steps"] == n_train // 32
    assert set(port) == set(jax_res) | {"thresholds", "train_steps"}
    assert set(port["test_metrics"]) == set(jax_res["test_metrics"])
    assert all(np.isfinite(v) for v in port["test_metrics"].values())
    proot, jroot = (str(tmp_path / s) for s in ("port", "jax"))
    pm = read_manifest(os.path.join(proot, "config_params.txt"))
    jm = read_manifest(os.path.join(jroot, "config_params.txt"))
    assert set(pm) == set(jm) | {"device"} and pm["device"] == "cpu"
    tags = {}
    for side, root in (("port", proot), ("jax", jroot)):
        with open(os.path.join(root, "logs", "metrics.jsonl")) as f:
            tags[side] = {json.loads(line)["tag"] for line in f}
    # the port logs three epoch-time splits more (ROADMAP.md queue C)
    assert tags["port"] == tags["jax"] | {
        "epoch_time_data_wait", "epoch_time_eval", "epoch_time_checkpoint"}
    assert sorted(f for f in os.listdir(os.path.join(proot, "weights"))
                  if not f.startswith(".")) == \
        sorted(f for f in os.listdir(os.path.join(jroot, "weights"))
               if not f.startswith(".")) == ["0", "best_model"]
    stats = {side: {d.rstrip("0123456789") for d in os.listdir(
        os.path.join(root, "stats"))} for side, root in (("port", proot),
                                                         ("jax", jroot))}
    assert stats["port"] == stats["jax"]
    for dump in ("predicted_scores.npy", "correct_labels.npy"):
        p = np.load(os.path.join(proot, "stats", dump))
        j = np.load(os.path.join(jroot, "stats", dump))
        assert p.shape == j.shape and p.dtype == j.dtype, dump
    np.testing.assert_array_equal(
        np.load(os.path.join(proot, "stats", "correct_labels.npy")),
        np.load(os.path.join(jroot, "stats", "correct_labels.npy")))


@pytest.mark.parametrize("flags,item", [("--n_model 2", "item 21")])
@pytest.mark.parametrize("name", sorted(CLIS))
def test_unported_flags_raise(tmp_path, name, flags, item):
    with pytest.raises(NotImplementedError, match=item):
        CLIS[name][1].main(_argv(tmp_path, "e", "--device", "cpu",
                                 *flags.split()))


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_runs_on_the_card_unless_asked(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        CLIS[name][1].main(_argv(tmp_path, "e"))
