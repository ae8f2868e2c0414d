"""The port's classifier CLIs (``cli/ethec_experiments.py``,
``cli/image_emb.py``, ``cli/common.py::inverse_class_weights``) on the CPU,
against the JAX package's.

* Flag parity: both parsers have every flag of their JAX twin with the
  same type, default, nargs, choices and requiredness, plus only
  ``--device``; the reference README's sample command and the full flag
  sets of the JAX CLI's own flag tests parse.
* One tiny run of each CLI (``--device cpu``, a bfloat16 ResNet-18 at 16²
  with oneDNN off, as the joint CLI tests run): train, ``--resume``,
  ``--set_mode test``, held to the JAX CLI's run on the same split in
  what does not depend on the BatchNorm's summation order (the JAX CLI
  runs flax's BatchNorm, the port its fused reductions): the files
  written, the checkpoint epochs, the manifest's keys and the score
  dumps' shapes (and ``correct_labels.npy`` exactly).
* Without ``--device`` and without a card the CLIs raise; the unported
  flags raise naming their ROADMAP item.
* ``image_emb`` features equal the JAX trunk's (float32 on both sides,
  the same weights) within rtol 1e-4, atol 1e-5; ``inverse_class_weights``
  equals the JAX package's exactly.
"""

import importlib
import os
import shlex
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import learning_embeddings_tpu.cli.common as jcommon
from learning_embeddings_tpu.cli import ethec_experiments as j_ethec
from learning_embeddings_tpu.cli import image_emb as j_emb
from learning_embeddings_tpu.models.resnet import BACKBONES as JAX_BACKBONES
import learning_embeddings_tpu_torch.cli.common as tcommon
from learning_embeddings_tpu_torch.cli import ethec_experiments as t_ethec
from learning_embeddings_tpu_torch.cli import image_emb as t_emb
from learning_embeddings_tpu_torch.models import resnet as tresnet
from learning_embeddings_tpu_torch.models import state_dict_from_jax
from learning_embeddings_tpu_torch.train.experiment import (Checkpointer,
                                                            ExperimentDir,
                                                            read_manifest)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """Both runners also log to tensorboard where it imports; that import
    pulls in TensorFlow (~15 s), so these tests keep to the jsonl mirror,
    which holds the same records."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


# ----------------------------------------------------------------------
# flags
# ----------------------------------------------------------------------
PARSERS = {"ethec_experiments": (j_ethec.build_parser, t_ethec.build_parser),
           "image_emb": (j_emb.build_parser, t_emb.build_parser)}


@pytest.fixture
def splits_dir_set(monkeypatch):
    """ETHEC_SPLITS_DIR set, the two `common` modules read again: the
    --data_dir default is the variable on both sides."""
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


#: port-only flags besides --device: the decode path, asked for by name
#: (the JAX CLIs take their native JPEG loader by themselves)
PORT_ONLY = {"ethec_experiments": {"loader"}, "image_emb": {"loader"}}
LOADER_SPEC = (("--loader",), "_StoreAction", None, "python", None,
               ["python", "native"], False)


@pytest.mark.parametrize("name", sorted(PARSERS))
def test_parser_has_the_jax_flags_plus_device(name, splits_dir_set):
    jax_build, port_build = PARSERS[name]
    want, got = _flags(jax_build()), _flags(port_build())
    assert set(got) == set(want) | {"device"} | PORT_ONLY.get(name, set())
    for dest, spec in want.items():
        assert got[dest] == spec, dest
    assert got["device"] == (("--device",), "_StoreAction", str, "cuda",
                             None, None, False)
    if name in PORT_ONLY:
        assert got["loader"] == LOADER_SPEC


COMMAND_LINES = {
    # the reference README's sample command
    "readme": "--experiment_name exp_test --experiment_dir exp "
              "--image_dir ETHEC_dataset_v0.1/ETHEC_dataset/"
              "IMAGO_build_test_resized/ --n_epochs 1 --model resnet18 "
              "--loss multi_level --set_mode train",
    "full": "--debug --lr 0.001 --batch_size 8 --evaluator ML "
            "--experiment_name e --experiment_dir d --image_dir i "
            "--n_epochs 2 --n_workers 4 --eval_interval 1 --resume "
            "--optimizer_method adam --merged --weight_strategy inv_sqrt "
            "--model resnet50 --loss masked_loss --use_grayscale "
            "--class_weights --freeze_weights --set_mode train "
            "--level_weights 1 1 1 1 --use_2d --lr_step 10 20",
    "additions": "--experiment_name e --experiment_dir d --image_dir i "
                 "--n_epochs 1 --model resnet18 --loss multi_level "
                 "--set_mode train --f32_input --grad_accum 4 --freeze_bn "
                 "--n_model 2",
}


@pytest.mark.parametrize("line", sorted(COMMAND_LINES))
def test_reference_command_lines_parse_alike(line):
    argv = shlex.split(COMMAND_LINES[line])
    got = vars(t_ethec.build_parser().parse_args(argv))
    want = vars(j_ethec.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got.pop("loader") == "python"
    got.pop("data_dir"), want.pop("data_dir")
    assert got == want


def test_loss_map_equals_jax():
    assert t_ethec.LOSS_MAP == j_ethec.LOSS_MAP


# ----------------------------------------------------------------------
# tiny runs
# ----------------------------------------------------------------------
def _records():
    recs = []
    for sp in range(6):
        g = sp // 2
        for k in range(5):
            i = len(recs)
            recs.append({"token": f"t{i:03d}", "family": f"F{g % 2}",
                         "subfamily": f"S{g % 2}", "genus": f"G{g}",
                         "specific_epithet": f"e{sp % 2}",
                         "image_path": f"d{g}",
                         "image_name": f"i{i:03d}.png"})
    return recs


@pytest.fixture(scope="module")
def png_split(tmp_path_factory):
    """Split jsons (3 train, 1 val, 1 test a species) and a 24×30 PNG a
    record."""
    from PIL import Image

    from learning_embeddings_tpu_torch import data as tdata

    root = tmp_path_factory.mktemp("ethec_cli")
    recs = _records()
    rng = np.random.RandomState(0)
    for r in recs:
        d = root / "images" / r["image_path"]
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.randint(0, 256, (24, 30, 3)).astype(
            np.uint8)).save(str(d / r["image_name"]))
    parts = {"train": [], "val": [], "test": []}
    for i, r in enumerate(recs):
        parts["train" if i % 5 < 3 else "val" if i % 5 == 3
              else "test"].append(r)
    (root / "splits").mkdir()
    for s, rs in parts.items():
        tdata.save_ethec_json(rs, str(root / "splits" / f"{s}.json"))
    return str(root / "splits"), str(root / "images")


@pytest.fixture
def native_cpu_convs(monkeypatch):
    """The CLI's trunk runs in bfloat16. At 16² images layer4's first conv
    sees a 1×1 map; on a CPU with AMX, oneDNN's bfloat16 weight gradient
    writes non-zero values, often NaN, into the taps that see only padding
    (``onednn_dw_repro.py``); PyTorch's native convolution does not."""
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)


def _argv(data, images, exp_dir, *extra):
    return ["--data_dir", data, "--image_dir", images, "--experiment_dir",
            exp_dir, "--experiment_name", "e", "--model", "resnet18",
            "--loss", "multi_level", "--image_size", "16", "--batch_size",
            "6", "--n_workers", "2", "--lr", "1e-5", *extra]


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_cli_trains_resumes_and_tests_like_jax(png_split, tmp_path,
                                               native_cpu_convs):
    data, images = png_split
    outs = {}
    for side, main, extra in (("port", t_ethec.main, ["--device", "cpu"]),
                              ("jax", j_ethec.main, [])):
        exp = str(tmp_path / side)
        runs = [main(_argv(data, images, exp, "--n_epochs", "2",
                           "--set_mode", "train", *extra)),
                main(_argv(data, images, exp, "--n_epochs", "3",
                           "--set_mode", "train", "--resume", *extra)),
                main(_argv(data, images, exp, "--n_epochs", "3",
                           "--set_mode", "test", *extra))]
        outs[side] = (exp, runs)
    (pexp, pruns), (jexp, jruns) = outs["port"], outs["jax"]
    proot, jroot = os.path.join(pexp, "e"), os.path.join(jexp, "e")
    for r in pruns:
        assert all(np.isfinite(v) for v in r["test_metrics"].values())
    assert Checkpointer(ExperimentDir(pexp, "e")).epochs_on_disk() == \
        [0, 1, 2]
    from learning_embeddings_tpu.train.experiment import (
        Checkpointer as JaxCheckpointer, ExperimentDir as JaxExperimentDir)
    assert JaxCheckpointer(JaxExperimentDir(jexp, "e")).epochs_on_disk() \
        == [0, 1, 2]
    # the same report directories and dumps, whatever epoch was best
    stats = {side: {d.rstrip("0123456789") for d in os.listdir(
        os.path.join(root, "stats"))} for side, root in (("port", proot),
                                                          ("jax", jroot))}
    assert stats["port"] == stats["jax"] == {
        "val", "test", "best_test", "correct_labels.npy",
        "predicted_scores.npy"}
    for dump in ("predicted_scores.npy", "correct_labels.npy"):
        p = np.load(os.path.join(proot, "stats", dump))
        j = np.load(os.path.join(jroot, "stats", dump))
        assert p.shape == j.shape and p.dtype == j.dtype, dump
    np.testing.assert_array_equal(
        np.load(os.path.join(proot, "stats", "correct_labels.npy")),
        np.load(os.path.join(jroot, "stats", "correct_labels.npy")))
    pm = read_manifest(os.path.join(proot, "config_params.txt"))
    jm = read_manifest(os.path.join(jroot, "config_params.txt"))
    assert set(pm) == set(jm) | {"device", "loader"}
    assert pm["device"] == "cpu" and pm["set_mode"] == "test"
    # the test-mode run scores the resumed run's best model, and reports
    # best epoch -1 as the JAX CLI does
    assert pruns[1]["best_epoch"] >= 0
    assert pruns[2]["best_epoch"] == jruns[2]["best_epoch"] == -1
    assert pruns[2]["test_metrics"] == pruns[1]["test_metrics"]


def test_cli_runs_on_the_card_unless_asked(png_split, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    data, images = png_split
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_ethec.main(_argv(data, images, str(tmp_path), "--n_epochs", "1",
                           "--set_mode", "train"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_emb.main(["--data_dir", data, "--image_dir", images])


@pytest.mark.parametrize("flags,item", [
    ("--n_model 2", "item 21"), ("--spatial_partition", "item 21")])
def test_unported_flags_raise(png_split, tmp_path, flags, item):
    data, images = png_split
    with pytest.raises(NotImplementedError, match=item):
        t_ethec.main(_argv(data, images, str(tmp_path), "--n_epochs", "1",
                           "--set_mode", "train", "--device", "cpu",
                           *flags.split()))


def test_inverse_class_weights_equal_jax(png_split):
    data, _ = png_split
    lm, ds, _ = tcommon.load_ethec_data(data)
    jlm, jds, _ = jcommon.load_ethec_data(data)
    got = tcommon.inverse_class_weights(ds["train"], lm)
    want = jcommon.inverse_class_weights(jds["train"], jlm)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_image_emb_features_equal_jax(png_split, tmp_path, monkeypatch):
    """The JAX CLI's seeded random trunk, carried into a port classifier
    checkpoint; both CLIs in float32."""
    data, images = png_split
    f32 = {k: (lambda f: lambda **kw: f(**{**kw, "dtype": jnp.float32}))(f)
           for k, f in JAX_BACKBONES.items()}
    monkeypatch.setattr(j_emb, "BACKBONES", f32)
    monkeypatch.setitem(tresnet.BACKBONES, "resnet18",
                        lambda **kw: tresnet.ResNet(
                            (2, 2, 2, 2), tresnet.BasicBlock,
                            **{**kw, "dtype": torch.float32}))
    trunk = f32["resnet18"](num_classes=None, features_only=True)
    variables = trunk.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 24, 24, 3), jnp.float32),
                           train=False)
    sd = state_dict_from_jax({"trunk": jax.device_get(variables["params"])},
                             {"trunk": jax.device_get(
                                 variables["batch_stats"])}, (2, 2, 2, 2))
    exp = ExperimentDir(str(tmp_path), "cls")
    Checkpointer(exp).save("best_model", {
        "params": {k: v for k, v in sd.items()
                   if not k.endswith(("running_mean", "running_var"))},
        "batch_stats": {k: v for k, v in sd.items()
                        if k.endswith(("running_mean", "running_var"))}})
    common = ["--data_dir", data, "--image_dir", images, "--model",
              "resnet18", "--image_size", "24", "--batch_size", "4",
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
            assert p["features"].shape[1] == 512
            assert p["features"].dtype == np.float32
            np.testing.assert_array_equal(p["paths"], j["paths"])
            np.testing.assert_allclose(p["features"], j["features"],
                                       rtol=1e-4, atol=1e-5)
