"""The port's CLIs (``learning_embeddings_tpu_torch/cli``) and its
ETHEC records (``data/records.py``) on the CPU, against the JAX package.

* The records functions and ``cli/common.load_ethec_data`` (with and
  without --debug, with and without train.json) on split jsons the tests
  write: the same labelmap, level labels, paths and split as the JAX
  package's (compared exactly: no arithmetic).
* Flag parity: each of the five parsers has every flag of its JAX twin
  with the same type, default, nargs, choices and requiredness, plus only
  ``--device``.
* The label-only CLIs end to end (``--device cpu``): the files a run
  writes, ``--resume`` starting at the next epoch with the best model
  kept, and ``validate_embedding`` re-scoring a run to its final
  reconstruction F1 (within 1e-6: the same table and the same f32 code).
* ``oe_h --use_CNN`` end to end on a tiny split of PNG images, warm-started
  from a label-only run's best_model (``--load_emb_from``), and ``oe``
  with the order energy. The fc7 path of these CLIs is tested in
  tests/test_torch_joint_fc7.py.
"""

import argparse
import importlib
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import learning_embeddings_tpu.cli.common as jcommon
from learning_embeddings_tpu import data as jdata
from learning_embeddings_tpu.cli import _joint_main as j_joint
from learning_embeddings_tpu.cli import embed_toy as j_toy
from learning_embeddings_tpu.cli import order_embeddings as j_oe
from learning_embeddings_tpu.cli import order_embeddings_h as j_oeh
from learning_embeddings_tpu.hierarchy import (
    labelmap_from_records as jax_labelmap_from_records)
import learning_embeddings_tpu_torch.cli.common as tcommon
from learning_embeddings_tpu_torch import data as tdata
from learning_embeddings_tpu_torch.cli import _joint_main as t_joint
from learning_embeddings_tpu_torch.cli import embed_toy as t_toy
from learning_embeddings_tpu_torch.cli import oe as t_oe_joint
from learning_embeddings_tpu_torch.cli import oe_h as t_oe_h
from learning_embeddings_tpu_torch.cli import order_embeddings as t_oe
from learning_embeddings_tpu_torch.cli import order_embeddings_h as t_oeh
from learning_embeddings_tpu_torch.cli import validate_embedding as t_val
from learning_embeddings_tpu_torch.hierarchy import labelmap_from_records
from learning_embeddings_tpu_torch.train.experiment import (Checkpointer,
                                                            ExperimentDir,
                                                            read_manifest)

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


# ----------------------------------------------------------------------
# a small ETHEC-style database
# ----------------------------------------------------------------------
#: specimens per species, cycling: < 3 (dropped by the split), < 10 (split
#: in thirds) and ≥ 10 (80/10/10) all occur
COUNTS = (1, 4, 12, 2, 7, 10, 3, 5)


def make_records():
    """2 families × 2 subfamilies × 2 genera × 2 species, database order
    grouped by species as the ETHEC jsons are."""
    recs, i = [], 0
    for f in range(2):
        for s in range(2):
            for g in range(2):
                for e in range(2):
                    sp = ((f * 2 + s) * 2 + g) * 2 + e
                    for _ in range(COUNTS[sp % len(COUNTS)]):
                        recs.append({
                            "token": f"t{i:04d}", "family": f"Fam{f}",
                            "subfamily": f"Sub{f}{s}",
                            "genus": f"Gen{f}{s}{g}",
                            "specific_epithet": f"ep{e}",
                            "image_path": f"d{f}{s}",
                            "image_name": f"img{i:04d}.png"})
                        i += 1
    return recs


def write_splits(root, with_train=True):
    """Split jsons under `root` (the port's stratified split of
    make_records()); returns {split: records}."""
    recs = make_records()
    lm = labelmap_from_records(recs)
    tr, va, te = tdata.stratified_split(recs, lm)
    splits = {"train": tr, "val": va, "test": te}
    os.makedirs(root, exist_ok=True)
    for name, rs in splits.items():
        if name != "train" or with_train:
            tdata.save_ethec_json(rs, os.path.join(root, f"{name}.json"))
    return splits


def _same_labelmap(a, b):
    assert a.level_names == b.level_names
    assert a.ix_to_name == b.ix_to_name
    assert np.array_equal(a.parent_ix, b.parent_ix)


def _same_dataset(a, b):
    assert np.array_equal(a.level_labels, b.level_labels)
    assert np.array_equal(a.leaf_labels, b.leaf_labels)
    assert a.image_paths == b.image_paths and a.tokens == b.tokens


def test_records_equal_jax(tmp_path):
    recs = make_records()
    path = str(tmp_path / "all.json")
    jdata.save_ethec_json(recs, path)
    loaded = tdata.load_ethec_json(path)
    assert loaded == jdata.load_ethec_json(path) == recs
    lm, jlm = labelmap_from_records(loaded), jax_labelmap_from_records(loaded)
    _same_labelmap(lm, jlm)
    _same_dataset(tdata.encode_records(loaded, lm),
                  jdata.encode_records(loaded, jlm))
    assert np.array_equal(tdata.encode_records(loaded, lm).multihot(lm),
                          jdata.encode_records(loaded, jlm).multihot(jlm))
    split = tdata.stratified_split(loaded, lm)
    assert split == jdata.stratified_split(loaded, jlm)
    assert sum(map(len, split)) < len(loaded)     # species of < 3 dropped
    small = labelmap_from_records(loaded[:30])
    jsmall = jax_labelmap_from_records(loaded[:30])
    assert tdata.filter_to_labelmap(loaded, small) == \
        jdata.filter_to_labelmap(loaded, jsmall)


@pytest.mark.parametrize("debug", [False, True])
@pytest.mark.parametrize("with_train", [True, False])
def test_load_ethec_data_equals_jax(tmp_path, debug, with_train):
    write_splits(str(tmp_path), with_train=with_train)
    lm, ds, recs = tcommon.load_ethec_data(str(tmp_path), debug, 5)
    jlm, jds, jrecs = jcommon.load_ethec_data(str(tmp_path), debug, 5)
    _same_labelmap(lm, jlm)
    assert recs == jrecs and set(ds) == {"train", "val", "test"}
    for split in ds:
        _same_dataset(ds[split], jds[split])
    if debug:
        assert lm.levels[-1] == 5


def test_load_ethec_data_needs_a_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match="ETHEC_SPLITS_DIR"):
        tcommon.load_ethec_data(None)
    with pytest.raises(FileNotFoundError, match="no ETHEC split json"):
        tcommon.load_ethec_data(str(tmp_path))


# ----------------------------------------------------------------------
# flag parity
# ----------------------------------------------------------------------
PARSERS = {
    "order_embeddings": (j_oe.build_parser, t_oe.build_parser),
    "order_embeddings_h": (j_oeh.build_parser, t_oeh.build_parser),
    "embed_toy": (j_toy.build_parser, t_toy.build_parser),
    "oe": (lambda: j_joint.build_parser("order_emb_loss"),
           lambda: t_joint.build_parser("order_emb_loss")),
    "oe_h": (lambda: j_joint.build_parser("hyp_cones_loss"),
             lambda: t_joint.build_parser("hyp_cones_loss")),
}


@pytest.fixture
def splits_dir_set(monkeypatch):
    """ETHEC_SPLITS_DIR set, the two `common` modules read again: the
    --data_dir default is the variable on both sides (the JAX package
    falls back to a fixed path without it, the port to none)."""
    monkeypatch.setenv("ETHEC_SPLITS_DIR", "splits/ETHEC")
    for mod in (jcommon, tcommon):
        importlib.reload(mod)
    yield
    monkeypatch.undo()
    for mod in (jcommon, tcommon):
        importlib.reload(mod)


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), type(a).__name__, a.type,
                     a.default, a.nargs, a.choices, a.required)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", sorted(PARSERS))
def test_parser_has_the_jax_flags_plus_device(name, splits_dir_set):
    jax_build, port_build = PARSERS[name]
    want, got = _flags(jax_build()), _flags(port_build())
    assert set(got) == set(want) | {"device"}
    for dest, spec in want.items():
        assert got[dest] == spec, dest
    assert got["device"] == (("--device",), "_StoreAction", str, "cuda",
                             None, None, False)


# ----------------------------------------------------------------------
# label-only CLIs
# ----------------------------------------------------------------------
def metrics(exp_root):
    with open(os.path.join(exp_root, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_order_embeddings_h_runs_and_resumes(tmp_path):
    base = ["--taxonomy", "butterfly200", "--set_mode", "train",
            "--experiment_dir", str(tmp_path), "--experiment_name", "h",
            "--batch_size", "64", "--device", "cpu"]
    t_oeh.main(base + ["--n_epochs", "2"])
    root = tmp_path / "h"
    for rel in ("config_params.txt", "weights/0", "weights/1",
                "weights/best_model", "logs/metrics.jsonl"):
        assert (root / rel).is_file(), rel
    manifest = read_manifest(str(root / "config_params.txt"))
    assert manifest["taxonomy"] == "butterfly200"
    assert manifest["device"] == "cpu" and "git_commit" in manifest
    ckpt = Checkpointer(ExperimentDir(str(tmp_path), "h"))
    best = ckpt.load("best_model", {"best_f1": -1.0, "best_epoch": -1.0})

    res = t_oeh.main(base + ["--n_epochs", "3", "--resume"])
    steps = [r["step"] for r in metrics(str(root))
             if r["tag"] == "train/loss"]
    assert steps == [0, 1, 2]          # the resumed run started at epoch 2
    val = {r["step"]: r["value"] for r in metrics(str(root))
           if r["tag"] == "val/f1"}
    assert res["best_val_f1"] == pytest.approx(max(val.values()))
    if val[2] <= best["best_f1"]:      # best_model still the earlier one
        assert res["best_epoch"] == int(best["best_epoch"])
    assert ckpt.find_existing_weights() == 2


def test_order_embeddings_then_validate_on_an_ethec_split(tmp_path):
    """The Euclidean CLI on a split directory, then validate_embedding
    rebuilds the run from its manifest: the same reconstruction F1."""
    data = str(tmp_path / "splits")
    write_splits(data)
    res = t_oe.main(["--loss", "order_emb_loss", "--data_dir", data,
                     "--set_mode", "train", "--experiment_dir",
                     str(tmp_path), "--experiment_name", "o",
                     "--n_epochs", "3", "--check_reconstr_every", "1",
                     "--device", "cpu"])
    rec = [r for r in metrics(str(tmp_path / "o"))
           if r["tag"] == "reconstruction/f1"]
    assert [r["step"] for r in rec] == [0, 1, 2]
    out = t_val.main(["--experiment_path", str(tmp_path / "o"),
                      "--device", "cpu"])
    assert abs(out["reconstruction_f1"] - res["reconstruction_f1"]) <= 1e-6
    assert 0.0 <= out["val_f1"] <= 1.0


def test_embed_toy_then_validate_roundtrip(tmp_path):
    """The port's twin of
    tests/test_runner.py::test_validate_embedding_cli_roundtrip, with the
    plot. The toy graph at --prop_of_nb_edges 0 has no val edges, so there
    is no best_model and validate_embedding takes the latest epoch."""
    pytest.importorskip("matplotlib")
    res = t_toy.main(("--pick_per_level --tree_levels 3 --tree_branching 2 "
                      "--n_epochs 6 --lr 0.03 --loss hyp_cones_loss "
                      "--embedding_dim 2 --neg_to_pos_ratio 3 --alpha 0.01 "
                      "--experiment_name v --batch_size 10 --device cpu "
                      f"--experiment_dir {tmp_path}").split())
    stats = tmp_path / "v" / "stats"
    assert (stats / "toy_embedding.png").is_file()
    assert (stats / "frames" / "epoch_0005.png").is_file()
    out = t_val.main(["--experiment_path", str(tmp_path / "v"), "--plot",
                      "--device", "cpu"])
    assert abs(out["reconstruction_f1"] - res["reconstruction_f1"]) <= 1e-6
    assert res["best_epoch"] == -1
    assert (stats / "validate_5.png").is_file()


# ----------------------------------------------------------------------
# joint CLIs (--use_CNN)
# ----------------------------------------------------------------------
@pytest.fixture
def native_cpu_convs(monkeypatch):
    """The joint CLIs' tower runs in bfloat16 (JointCNNConfig's
    default; the CLI has no flag for it). At 16² images, layer4's first
    conv (3×3, stride 2, padding 1) sees a 1×1 map, so eight of its nine
    taps meet only padding and their weight gradient is 0. On a CPU with
    AMX, oneDNN's bfloat16 weight gradient writes non-zero values there,
    often NaN, and differs bit-wise from call to call; PyTorch's native
    convolution gives zeros there and the same bits on every call
    (``onednn_dw_repro.py`` reproduces it on random inputs)."""
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)


@pytest.fixture(scope="module")
def png_split(tmp_path_factory):
    """Split jsons and a 24² PNG per record."""
    from PIL import Image

    root = tmp_path_factory.mktemp("ethec")
    data, images = str(root / "splits"), str(root / "images")
    splits = write_splits(data)
    rng = np.random.RandomState(0)
    for rs in splits.values():
        for r in rs:
            d = os.path.join(images, r["image_path"])
            os.makedirs(d, exist_ok=True)
            Image.fromarray(rng.randint(0, 256, (24, 24, 3)).astype(
                np.uint8)).save(os.path.join(d, r["image_name"]))
    return data, images


def test_oe_h_use_cnn_end_to_end(png_split, exp_dir, native_cpu_convs):
    data, images = png_split
    t_oeh.main(["--taxonomy", "ethec", "--data_dir", data, "--set_mode",
                "train", "--experiment_dir", str(exp_dir),
                "--experiment_name", "lab", "--n_epochs", "2",
                "--device", "cpu"])
    warm = str(exp_dir / "lab" / "weights" / "best_model")
    res = t_oe_h.main(["--use_CNN", "--data_dir", data, "--image_dir",
                       images, "--image_size", "16", "--batch_size", "16",
                       "--n_epochs", "1", "--set_mode", "train",
                       "--experiment_dir", str(exp_dir),
                       "--experiment_name", "joint", "--load_emb_from",
                       warm, "--eval_max_images", "6", "--device", "cpu"])
    root = exp_dir / "joint"
    for rel in ("config_params.txt", "weights/0", "weights/best_model"):
        assert (root / rel).is_file(), rel
    manifest = read_manifest(str(root / "config_params.txt"))
    assert manifest["model"] == "resnet18" and manifest["use_CNN"] == "True"
    assert np.isfinite(res["reconstruction_f1"])
    assert all(np.isfinite(v) for v in res["test_metrics"].values())
    assert "edge_f1" in res["test_metrics"]
    assert res["trainer"].cfg.energy == "hyp_cone"

    # the warm start: the label-only run's table and threshold
    payload = Checkpointer(ExperimentDir(str(exp_dir), "lab")).load_raw(
        "best_model")
    table, thr = t_joint.load_warm_start(argparse.Namespace(
        load_emb_from=warm, load_cosine_emb=None), 0)
    assert np.array_equal(table, payload["params"]["embedding"].numpy())
    assert thr == payload["optimal_threshold"]


def test_oe_use_cnn_order_energy(png_split, exp_dir, native_cpu_convs):
    data, images = png_split
    res = t_oe_joint.main(["--use_CNN", "--data_dir", data, "--image_dir",
                           images, "--image_size", "16", "--batch_size",
                           "16", "--n_epochs", "1", "--set_mode", "train",
                           "--experiment_dir", str(exp_dir),
                           "--experiment_name", "o", "--eval_max_images",
                           "6", "--device", "cpu"])
    assert res["trainer"].cfg.energy == "order"
    assert np.isfinite(res["reconstruction_f1"])


def test_load_warm_start_cosine_table(tmp_path):
    path = str(tmp_path / "cos.npy")
    np.save(path, np.arange(10, dtype=np.float32).reshape(5, 2))
    args = argparse.Namespace(load_emb_from=None, load_cosine_emb=path,
                              embedding_dim=4)
    table, thr = t_joint.load_warm_start(args, 5)
    assert thr is None and table.shape == (5, 4)
    assert np.array_equal(table[:, :2], np.arange(10).reshape(5, 2))
    assert not table[:, 2:].any()
    with pytest.raises(ValueError, match="rows"):
        t_joint.load_warm_start(args, 6)
    assert t_joint.load_warm_start(argparse.Namespace(
        load_emb_from=None, load_cosine_emb=None), 5) == (None, None)


@pytest.mark.parametrize("loss,default,energy", [
    ("euc_cones_loss", "hyp_cones_loss", "hyp_cone"),
    ("euc_cones_loss", "order_emb_loss", "euc_cone"),
    ("order_emb_loss", "hyp_cones_loss", "order"),
    ("hyp_cones_loss", "order_emb_loss", "hyp_cone")])
def test_resolve_energy_equals_jax(loss, default, energy):
    assert t_joint.resolve_energy(loss, default) == energy == \
        j_joint.resolve_energy(loss, default)
