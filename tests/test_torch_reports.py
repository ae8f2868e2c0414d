"""The port's report modules against the JAX package's, on the CPU:
``eval/confusion.py``, ``hierarchy/stats.py`` and ``utils/tblog.py`` (numpy
copies: bit for bit on the same seeded inputs), and the report CLIs
``cli/post_process.py`` and ``cli/convert_tblog.py`` (the same flags, the
same files and printed summary on the same experiment)."""

import os
import shutil
import sys

import numpy as np
import pytest

from learning_embeddings_tpu.cli import convert_tblog as j_convert
from learning_embeddings_tpu.cli import post_process as j_post
from learning_embeddings_tpu.eval import confusion as jconf
from learning_embeddings_tpu.hierarchy import labelmap as jlabelmap
from learning_embeddings_tpu.hierarchy import stats as jstats
from learning_embeddings_tpu.utils import tblog as jtblog
from learning_embeddings_tpu_torch import eval as teval
from learning_embeddings_tpu_torch.cli import convert_tblog as t_convert
from learning_embeddings_tpu_torch.cli import post_process as t_post
from learning_embeddings_tpu_torch.data import save_ethec_json
from learning_embeddings_tpu_torch.eval import confusion as tconf
from learning_embeddings_tpu_torch.hierarchy import labelmap as tlabelmap
from learning_embeddings_tpu_torch.hierarchy import stats as tstats
from learning_embeddings_tpu_torch.train.experiment import (ExperimentDir,
                                                            MetricsLogger,
                                                            write_manifest)
from learning_embeddings_tpu_torch.utils import tblog as ttblog

#: (JAX, port) taxonomies of the same shape
TAXONOMIES = {
    "toy_3_3": lambda m: m.toy_labelmap(3, 3),
    "toy_2_4": lambda m: m.toy_labelmap(2, 4),
    "butterfly200": lambda m: m.butterfly200_labelmap(),
}


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The port's MetricsLogger also writes tensorboard events where
    ``torch.utils.tensorboard`` imports; that import pulls in TensorFlow
    (~15 s), so these tests keep to the jsonl mirror."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _both(name):
    return TAXONOMIES[name](jlabelmap), TAXONOMIES[name](tlabelmap)


def _scores(lm, n, seed):
    rng = np.random.RandomState(seed)
    ll = lm.leaf_paths()[rng.randint(0, lm.levels[-1], n)].astype(np.int32)
    return rng.randn(n, lm.n_classes).astype(np.float32), ll


@pytest.mark.parametrize("name", sorted(TAXONOMIES))
def test_child_sorted_order_equals_jax(name):
    jlm, tlm = _both(name)
    for level in range(tlm.n_levels):
        got = tconf.child_sorted_order(tlm, level)
        want = jconf.child_sorted_order(jlm, level)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("child_sorted", [True, False])
@pytest.mark.parametrize("name", sorted(TAXONOMIES))
def test_cross_level_confusion_equals_jax(name, child_sorted):
    jlm, tlm = _both(name)
    scores, ll = _scores(tlm, 300, 1)
    for p in range(tlm.n_levels):
        for g in range(tlm.n_levels):
            got = tconf.cross_level_confusion(scores, ll, tlm, p, g,
                                              child_sorted=child_sorted)
            want = jconf.cross_level_confusion(scores, ll, jlm, p, g,
                                               child_sorted=child_sorted)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_cross_level_confusion_is_exported():
    assert teval.cross_level_confusion is tconf.cross_level_confusion


def test_plot_cross_level_confusion_writes(tmp_path):
    m = np.arange(12).reshape(3, 4)
    path = str(tmp_path / "sub" / "c.png")
    tconf.plot_cross_level_confusion(m, path, title="t")
    assert os.path.getsize(path) > 0


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("name", sorted(TAXONOMIES))
def test_graph_stats_and_d3_export_equal_jax(tmp_path, name, with_counts):
    jlm, tlm = _both(name)
    counts = (np.random.RandomState(2).randint(0, 50, tlm.n_classes)
              if with_counts else None)
    assert tstats.graph_stats(tlm, counts) == jstats.graph_stats(jlm, counts)
    got = tstats.export_d3_json(tlm, str(tmp_path / "t.json"), counts)
    want = jstats.export_d3_json(jlm, str(tmp_path / "j.json"), counts)
    assert got == want
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()


# ----------------------------------------------------------------------
# tblog
# ----------------------------------------------------------------------
def _log_experiment(root, name, n_epochs=4, seed=0):
    """An experiment whose logs/metrics.jsonl the port's MetricsLogger
    wrote."""
    rng = np.random.RandomState(seed)
    exp = ExperimentDir(str(root), name)
    logger = MetricsLogger(exp)
    for epoch in range(n_epochs):
        logger.scalar("train/loss", float(rng.rand()), epoch)
        logger.scalars("val", {"micro_f1": float(rng.rand()),
                               "family/accuracy": float(rng.rand())}, epoch)
        logger.scalar("epoch_time", float(rng.rand()), epoch)
    logger.close()
    return exp


def test_read_jsonl_scalars_equals_jax(tmp_path):
    exp = _log_experiment(tmp_path, "e")
    got = ttblog.read_jsonl_scalars(os.path.join(exp.logs, "metrics.jsonl"))
    want = jtblog.read_jsonl_scalars(os.path.join(exp.logs, "metrics.jsonl"))
    assert got == want
    assert sorted(got) == ["epoch_time", "train/loss", "val/family/accuracy",
                           "val/micro_f1"]
    assert [s for s, _ in got["train/loss"]] == [0, 1, 2, 3]


def test_read_scalars_equals_jax(tmp_path):
    """Tensorboard event files (simple_value scalars, as a SummaryWriter
    writes them) read the same through both readers."""
    from tensorboard.compat.proto import event_pb2, summary_pb2
    from tensorboard.summary.writer.event_file_writer import EventFileWriter

    writer = EventFileWriter(str(tmp_path))
    for step in range(3):
        for tag, value in (("train/loss", float(3 - step)),
                           ("val/micro_f1", 0.25 * step)):
            writer.add_event(event_pb2.Event(
                step=step, wall_time=float(step),
                summary=summary_pb2.Summary(value=[summary_pb2.Summary.Value(
                    tag=tag, simple_value=value)])))
    writer.close()
    got = ttblog.read_scalars(str(tmp_path))
    assert got == jtblog.read_scalars(str(tmp_path))
    assert got["train/loss"] == [(0, 3.0), (1, 2.0), (2, 1.0)]


@pytest.mark.parametrize("tags", [None, ["val/micro_f1", "absent"]])
def test_export_plots_writes_what_jax_writes(tmp_path, tags):
    scalars = {n: ttblog.read_jsonl_scalars(os.path.join(
        _log_experiment(tmp_path, n, seed=i).logs, "metrics.jsonl"))
        for i, n in enumerate(("a", "b"))}
    got = ttblog.export_plots(scalars, str(tmp_path / "t"), tags=tags,
                              fmt="png")
    want = jtblog.export_plots(scalars, str(tmp_path / "j"), tags=tags,
                               fmt="png")
    assert [os.path.relpath(p, tmp_path / "t") for p in got] == \
        [os.path.relpath(p, tmp_path / "j") for p in want]
    assert all(os.path.getsize(p) > 0 for p in got)


# ----------------------------------------------------------------------
# the report CLIs
# ----------------------------------------------------------------------
def _flags(parser):
    return {a.dest: (tuple(a.option_strings), type(a).__name__, a.type,
                     a.default, a.nargs, a.choices, a.required)
            for a in parser._actions if a.dest != "help"}


def _jax_parser(main):
    """The JAX CLI's parser: it builds it inside main(), so capture it."""
    import argparse

    captured = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        captured["parser"] = self
        raise SystemExit(0)
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return captured["parser"]


@pytest.mark.parametrize("name", ["post_process", "convert_tblog"])
def test_report_cli_flags_equal_jax(name):
    """The same flags (these CLIs only read files: no --device)."""
    jmain, tbuild = {"post_process": (j_post.main, t_post.build_parser),
                     "convert_tblog": (j_convert.main,
                                       t_convert.build_parser)}[name]
    assert _flags(tbuild()) == _flags(_jax_parser(jmain))


def _records(lm):
    """Two ETHEC records of every leaf of the taxonomy, so that the CLI
    rebuilds it from them."""
    recs = []
    for leaf, path in enumerate(lm.leaf_paths()):
        names = [lm.ix_to_name[l][path[l]] for l in range(4)]
        epithet = names[3].split(".", 1)[-1][len(names[2]) + 1:]
        for k in range(2):
            recs.append({"token": f"t{leaf}_{k}", "family": names[0],
                         "subfamily": names[1], "genus": names[2],
                         "specific_epithet": epithet, "image_path": "d",
                         "image_name": f"{leaf}_{k}.png"})
    return recs


@pytest.fixture
def scored_experiment(tmp_path):
    """A classifier experiment's files as run_classifier leaves them: the
    manifest (pointing at the split jsons) and the test score dumps."""
    lm = tlabelmap.butterfly200_labelmap()
    recs = _records(lm)
    (tmp_path / "splits").mkdir()
    for split, part in (("train", recs[0::2]), ("test", recs[1::2])):
        save_ethec_json(part, str(tmp_path / "splits" / f"{split}.json"))
    exp = ExperimentDir(str(tmp_path / "exps"), "e")
    write_manifest(exp, {"data_dir": str(tmp_path / "splits"),
                         "debug": False, "model": "resnet18"})
    scores, ll = _scores(lm, 120, 5)
    np.save(os.path.join(exp.stats, "predicted_scores.npy"), scores)
    np.save(os.path.join(exp.stats, "correct_labels.npy"), ll)
    return exp.root


@pytest.mark.parametrize("levels", [(0, 3), (3, 1), (2, 2)])
def test_post_process_cli_equals_jax(scored_experiment, tmp_path, capsys,
                                     levels):
    jroot = str(tmp_path / "jax_copy")
    shutil.copytree(scored_experiment, jroot)
    argv = ["--predicted_level", str(levels[0]), "--gt_level",
            str(levels[1])]
    got = t_post.main(["--experiment_path", scored_experiment, *argv])
    t_out = capsys.readouterr().out
    want = j_post.main(["--experiment_path", jroot, *argv])
    j_out = capsys.readouterr().out
    assert os.path.relpath(got, scored_experiment) == \
        os.path.relpath(want, jroot) == os.path.join(
            "stats", f"confusion_p{levels[0]}_g{levels[1]}.png")
    assert os.path.getsize(got) > 0
    assert t_out.replace(scored_experiment, jroot) == j_out
    if levels[0] == levels[1]:
        assert "weighted accuracy" in t_out


def test_convert_tblog_cli_equals_jax(tmp_path, capsys):
    exps = [_log_experiment(tmp_path / "exps", n, seed=i).root
            for i, n in enumerate(("a", "b"))]
    got = t_convert.main(["--experiment_path", *exps, "--output_dir",
                          str(tmp_path / "t"), "--fmt", "png"])
    t_out = capsys.readouterr().out
    want = j_convert.main(["--experiment_path", *exps, "--output_dir",
                           str(tmp_path / "j"), "--fmt", "png"])
    j_out = capsys.readouterr().out
    assert len(got) == 4
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert t_out.replace(str(tmp_path / "t"), "") == \
        j_out.replace(str(tmp_path / "j"), "")
