"""The port's inference harness (``cli/inference.py``) against the JAX
package's, on the CPU.

* Carried weights: a JAX ``ClassifierTrainer``'s parameters, with random
  BatchNorm running statistics, move into a port trainer through
  ``models/jax_import.py::state_dict_from_jax``. On the same seeded images
  the port's ``_trunk_apply``, the per-level softmax ``predict`` of LIME,
  the occlusion drop maps and the LIME coefficients equal the JAX
  package's computations: within rtol 1e-4 / atol 1e-5 of the reference
  with a float32 trunk on both sides (two summation orders), and within
  5e-2 of the reference's largest magnitude with bfloat16 trunks (both
  sides round every activation to 8 bits of mantissa, in other orders;
  for the drop maps, differences of two logits, 5e-2 of the largest
  logit).
* uint8 and float32 images give the same features and drop maps (the
  float path is not scaled a second time; the gray patch is written into
  the [0, 1] image).
* End to end through ``main(argv)`` with ``--device cpu``: a tiny
  experiment trained with the port's ``cli.ethec_experiments`` and one
  trained with the JAX CLI on the same records; ``cli.inference`` in all
  three modes, ``cli.post_process`` and ``cli.convert_tblog`` on both
  write the same files, ``summary.md`` headings and array shapes.
* A ``--use_2d``, a grayscale and a ``last_level`` (leaf head) experiment
  rebuild the head and stem they trained and load strictly.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from learning_embeddings_tpu.cli import convert_tblog as j_convert
from learning_embeddings_tpu.cli import ethec_experiments as j_ethec
from learning_embeddings_tpu.cli import inference as j_inf
from learning_embeddings_tpu.cli import post_process as j_post
from learning_embeddings_tpu.hierarchy import labelmap as jlabelmap
from learning_embeddings_tpu.train.classifier import (
    ClassifierConfig as JaxClassifierConfig,
    ClassifierTrainer as JaxClassifierTrainer)
from learning_embeddings_tpu.viz.lime import lime_explain as j_lime_explain
from learning_embeddings_tpu_torch.cli import convert_tblog as t_convert
from learning_embeddings_tpu_torch.cli import ethec_experiments as t_ethec
from learning_embeddings_tpu_torch.cli import inference as t_inf
from learning_embeddings_tpu_torch.cli import post_process as t_post
from learning_embeddings_tpu_torch.hierarchy import labelmap as tlabelmap
from learning_embeddings_tpu_torch.models import state_dict_from_jax
from learning_embeddings_tpu_torch.train.classifier import (
    ClassifierConfig, ClassifierTrainer)
from learning_embeddings_tpu_torch.viz.lime import slic_segments

torch.set_num_threads(2)

STAGES18 = (2, 2, 2, 2)
SIZE = 32


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The runners also log to tensorboard where it imports; that import
    pulls in TensorFlow (~15 s), so these tests keep to the jsonl mirror."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture
def native_cpu_convs(monkeypatch):
    """bfloat16 trunks at small sizes: on a CPU with AMX, oneDNN's bf16
    convolutions misbehave on taps that see only padding
    (``onednn_dw_repro.py``); PyTorch's native convolution does not."""
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)


# ----------------------------------------------------------------------
# carried weights
# ----------------------------------------------------------------------
def _pair(criterion="multi_level_ce", head_override=None, dtype="f32"):
    """(JAX trainer, port trainer) with the same weights: the JAX
    trainer's seeded parameters and random running statistics."""
    jdtype, tdtype = {"f32": (jnp.float32, torch.float32),
                      "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jlm, tlm = jlabelmap.toy_labelmap(2, 3), tlabelmap.toy_labelmap(2, 3)
    jtr = JaxClassifierTrainer(jlm, JaxClassifierConfig(
        backbone="resnet18", criterion=criterion, image_size=SIZE,
        batch_size=4, dtype=jdtype, head_override=head_override))
    rng = np.random.RandomState(0)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = str(path[-1].key)
        return (0.1 * rng.randn(*leaf.shape).astype(np.float32)
                if name == "mean"
                else rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32))
    stats = jax.tree_util.tree_map_with_path(perturb, jax.device_get(
        jtr.state.batch_stats))
    jtr.state = jtr.state.replace(batch_stats=stats)
    ttr = ClassifierTrainer(tlm, ClassifierConfig(
        backbone="resnet18", criterion=criterion, image_size=SIZE,
        batch_size=4, dtype=tdtype, head_override=head_override,
        device="cpu"))
    ttr.model.load_state_dict(state_dict_from_jax(
        jax.device_get(jtr.state.params), stats, STAGES18), strict=True)
    return jtr, ttr


def _images(n, seed=1, channels=3):
    return np.random.RandomState(seed).randint(
        0, 256, (n, SIZE, SIZE, channels)).astype(np.uint8)


def _jax_logits(jtr, images):
    return np.asarray(jtr.model.apply(
        {"params": jtr.state.params, "batch_stats": jtr.state.batch_stats},
        jnp.asarray(images), train=False))


def _jax_predict(jtr, slices):
    """run_lime's inline predict (JAX inference.py:449-453)."""
    def predict(images):
        raw = _jax_logits(jtr, images)
        return np.concatenate([np.asarray(jax.nn.softmax(raw[:, a:b], -1))
                               for _, a, b in slices], axis=1)
    return predict


def _jax_occlusion(jtr, img, ll, slices, patch, stride):
    """run_occlusion's maps (JAX inference.py:522-547)."""
    base = _jax_logits(jtr, img)[0]
    ys = list(range(0, SIZE - patch + 1, stride))
    xs = list(range(0, SIZE - patch + 1, stride))
    occluded = []
    for y in ys:
        for x in xs:
            o = img.copy()
            o[0, y:y + patch, x:x + patch] = 0.5
            occluded.append(o[0])
    occ = np.concatenate([_jax_logits(jtr, np.stack(occluded[s:s + 32]))
                          for s in range(0, len(occluded), 32)])
    return np.stack([(base[a + int(ll[l])] - occ[:, a + int(ll[l])])
                     .reshape(len(ys), len(xs)) for l, a, _ in slices])


def _close(got, want, dtype, scale=None):
    """f32: rtol 1e-4, atol 1e-5. bf16: within 5e-2 of `scale`, the
    largest magnitude of the values the compared ones are computed from
    (by default the reference's own)."""
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        scale = np.abs(want).max() if scale is None else scale
        assert np.abs(got - want).max() <= 5e-2 * scale


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_trunk_apply_equals_jax(dtype, native_cpu_convs):
    jtr, ttr = _pair(dtype=dtype)
    x = _images(5).astype(np.float32) / 255.0
    got = t_inf._trunk_apply(ttr, x)
    want = np.asarray(j_inf._trunk_apply(jtr, jnp.asarray(x)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 512)
    _close(got.numpy(), want.astype(np.float32), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lime_predict_and_coefficients_equal_jax(dtype, native_cpu_convs):
    jtr, ttr = _pair(dtype=dtype)
    slices = t_inf.level_slices(ttr)
    lm = ttr.labelmap
    assert slices == [(l, int(lm.level_start[l]), int(lm.level_stop[l]))
                      for l in range(lm.n_levels)]
    x = _images(6, seed=2).astype(np.float32) / 255.0
    predict = t_inf.lime_predict(ttr, slices)
    got, want = predict(x), _jax_predict(jtr, slices)(x)
    assert got.shape == want.shape == (6, lm.n_classes)
    _close(got, want, dtype)
    img = x[0]
    seg = slic_segments(img, n_segments=12)
    coefs, probs0 = t_inf.lime_coefficients(predict, img, seg,
                                            num_perturb=40)
    jcoefs, jprobs0 = j_lime_explain(img, _jax_predict(jtr, slices), seg,
                                     num_samples=40, hide_color=0.0,
                                     rng=np.random.RandomState(0))
    assert coefs.shape == jcoefs.shape == (lm.n_classes, seg.max() + 1)
    _close(probs0, jprobs0, dtype)
    _close(coefs, jcoefs, dtype)


@pytest.mark.parametrize("criterion,head,dtype", [
    ("multi_level_ce", None, "f32"), ("multi_level_ce", None, "bf16"),
    ("last_level_ce", None, "f32"), ("multi_level_ce", "bottleneck2d",
                                     "f32")])
def test_occlusion_maps_equal_jax(criterion, head, dtype, native_cpu_convs):
    jtr, ttr = _pair(criterion, head, dtype)
    lm = ttr.labelmap
    slices = t_inf.level_slices(ttr)
    if criterion == "last_level_ce":
        # a leaf head explains only the leaf level, at offset 0
        assert slices == [(lm.n_levels - 1, 0, lm.levels[-1])]
    else:
        assert len(slices) == lm.n_levels
    img = _images(1, seed=3).astype(np.float32) / 255.0
    ll = lm.leaf_paths()[5]
    # 56 / 28 clamp to S // 4 = 8 at 32²: a 4 × 4 grid
    got = t_inf.occlusion_maps(ttr, img, ll, slices, patch=56, stride=28)
    want = _jax_occlusion(jtr, img, ll, slices, patch=8, stride=8)
    assert got.shape == want.shape == (len(slices), 4, 4)
    # a drop is the difference of two logits: in bf16 its error scales
    # with the logits, not with the (smaller) drop
    _close(got, want, dtype, scale=np.abs(_jax_logits(jtr, img)).max())


def test_uint8_and_float_images_agree():
    """The trainers scale uint8 on the device; float images in [0, 1]
    (the inference pipeline's) pass through: the same features and maps,
    bit for bit."""
    _, ttr = _pair()
    u8 = _images(3, seed=4)
    f32 = u8.astype(np.float32) / 255.0
    assert torch.equal(t_inf._trunk_apply(ttr, u8),
                       t_inf._trunk_apply(ttr, f32))
    slices = t_inf.level_slices(ttr)
    ll = ttr.labelmap.leaf_paths()[2]
    for stride in (8, 5):
        maps = t_inf.occlusion_maps(ttr, u8[:1], ll, slices, 8, stride)
        np.testing.assert_array_equal(
            maps, t_inf.occlusion_maps(ttr, f32[:1], ll, slices, 8, stride))
        # another batch split of the occluded images: the same maps up to
        # the convolutions' summation order
        np.testing.assert_allclose(
            t_inf.occlusion_maps(ttr, u8[:1], ll, slices, 8, stride,
                                 batch_size=7), maps, rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------
# end to end, against the JAX CLIs
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

    root = tmp_path_factory.mktemp("inference")
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
    return root


def _train_argv(root, exp_dir, name, *extra):
    return ["--data_dir", str(root / "splits"), "--image_dir",
            str(root / "images"), "--experiment_dir", str(exp_dir),
            "--experiment_name", name, "--model", "resnet18", "--loss",
            "multi_level", "--image_size", "16", "--batch_size", "6",
            "--n_workers", "2", "--lr", "1e-3", "--n_epochs", "1",
            "--set_mode", "train", *extra]


@pytest.fixture(scope="module")
def trained(png_split):
    """One experiment trained by each CLI on the same records."""
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    try:
        t_ethec.main(_train_argv(png_split, png_split / "port", "e",
                                 "--device", "cpu"))
        j_ethec.main(_train_argv(png_split, png_split / "jax", "e"))
        yield png_split
    finally:
        mp.undo()
        torch.backends.mkldnn.enabled = prev


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _headings(path):
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.startswith("#")]


def test_inference_flags_are_jax_plus_device():
    import argparse

    captured = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        captured["parser"] = self
        raise SystemExit(0)
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            j_inf.main([])
    finally:
        argparse.ArgumentParser.parse_args = real

    def flags(parser):
        return {a.dest: (tuple(a.option_strings), type(a).__name__, a.type,
                         a.default, a.nargs, a.choices, a.required)
                for a in parser._actions if a.dest != "help"}
    want, got = flags(captured["parser"]), flags(t_inf.build_parser())
    assert set(got) == set(want) | {"device"}
    assert all(got[k] == v for k, v in want.items())
    assert got["device"][3] == "cuda"


@pytest.mark.parametrize("mode", ["occlusion", "lime", "tsne"])
def test_inference_cli_writes_what_jax_writes(trained, mode,
                                              native_cpu_convs):
    root = trained
    outs = {}
    for side, main, extra in (("port", t_inf.main, ["--device", "cpu"]),
                              ("jax", j_inf.main, [])):
        exp = str(root / side / "e")
        main(["--experiment_path", exp, "--image_dir", str(root / "images"),
              "--mode", mode, "--n_samples", "2", *extra])
        outs[side] = exp
    pstats, jstats = (os.path.join(outs[s], "stats") for s in ("port",
                                                               "jax"))
    sub = {"occlusion": "occlusion_test", "lime": "lime_test",
           "tsne": "tsne_test"}[mode]
    assert _tree(os.path.join(pstats, sub)) == \
        _tree(os.path.join(jstats, sub))
    if mode == "tsne":
        for f in ("test_representations.npy", "test_level_labels.npy"):
            p = np.load(os.path.join(pstats, f))
            j = np.load(os.path.join(jstats, f))
            assert p.shape == j.shape and p.dtype == j.dtype, f
            assert np.isfinite(p).all()
        np.testing.assert_array_equal(
            np.load(os.path.join(pstats, "test_level_labels.npy")),
            np.load(os.path.join(jstats, "test_level_labels.npy")))
        assert np.load(os.path.join(pstats, "test_representations.npy")
                       ).shape == (6, 512)
    else:
        md = os.path.join(pstats, sub, "summary.md")
        assert _headings(md) == _headings(os.path.join(jstats, sub,
                                                       "summary.md"))
        if mode == "lime":
            text = open(md).read()
            assert "Predicted:" in text and "color:" in text


def test_report_clis_on_a_trained_experiment(trained, capsys):
    root = trained
    for side, post, convert in (("port", t_post.main, t_convert.main),
                                ("jax", j_post.main, j_convert.main)):
        exp = str(root / side / "e")
        out = post(["--experiment_path", exp, "--predicted_level", "3",
                    "--gt_level", "1"])
        assert os.path.getsize(out) > 0
        written = convert(["--experiment_path", exp, "--output_dir",
                           str(root / f"plots_{side}"), "--fmt", "png"])
        assert written
    capsys.readouterr()
    # the port's runner logs three epoch-time splits more (ROADMAP.md
    # queue C); every JAX plot has its port twin
    port, jax_ = (set(os.listdir(root / f"plots_{s}"))
                  for s in ("port", "jax"))
    assert jax_ <= port and port - jax_ == {
        "epoch_time_data_wait.png", "epoch_time_eval.png",
        "epoch_time_checkpoint.png"}


def test_inference_runs_on_the_card_unless_asked(trained):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_inf.main(["--experiment_path", str(trained / "port" / "e"),
                    "--image_dir", str(trained / "images"), "--mode",
                    "tsne"])


@pytest.mark.parametrize("flags,head,channels", [
    (["--use_2d"], "bottleneck2d", 3),
    (["--use_grayscale"], "multi_head", 1),
    (["--loss", "last_level"], "leaf", 3)],
    ids=["use_2d", "grayscale", "leaf"])
def test_rebuild_loads_what_was_trained(png_split, tmp_path, flags, head,
                                        channels, native_cpu_convs):
    """The experiment rebuilds with the head and stem it trained, loads
    the best model strictly (the rebuilt weights equal the checkpoint's),
    and explains: occlusion maps per explained level, LIME rendering."""
    from learning_embeddings_tpu_torch.train.experiment import (
        Checkpointer, ExperimentDir)

    argv = _train_argv(png_split, tmp_path, "x", "--device", "cpu")
    if flags[0] == "--loss":
        argv[argv.index("multi_level")] = flags[1]
    else:
        argv += flags
    t_ethec.main(argv)
    exp_path = str(tmp_path / "x")
    lm, datasets, trainer, manifest, exp, gray = \
        t_inf.rebuild_from_manifest(exp_path, device="cpu")
    assert trainer.model.head == head and gray == (channels == 1)
    assert trainer.model.trunk.conv1.in_channels == channels
    payload = Checkpointer(ExperimentDir(str(tmp_path), "x")).load_raw(
        "best_model")
    state = trainer.model.state_dict()
    for k, v in {**payload["params"], **payload["batch_stats"]}.items():
        assert torch.equal(state[k], v), k
    slices = t_inf.level_slices(trainer)
    assert len(slices) == (1 if head == "leaf" else lm.n_levels)
    img = _images(1, channels=channels)[:, :16, :16]
    maps = t_inf.occlusion_maps(trainer, img, lm.leaf_paths()[0], slices)
    assert maps.shape == (len(slices), 4, 4) and np.isfinite(maps).all()
    out = t_inf.run_lime(exp_path, str(png_split / "images"), n_samples=1,
                         num_perturb=20, n_slic_segments=8, device="cpu")
    pngs = [f for f in os.listdir(out) if f.endswith(".png")]
    assert pngs and all(f.split("_")[1] in {str(l) for l, _, _ in slices}
                        for f in pngs)
