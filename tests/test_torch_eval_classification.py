"""The port's classification metrics (``eval/metrics.py``), multi-label
evaluation (``eval/multilabel.py``) and report writer (``eval/reports.py``)
against the JAX package on the same scores.

Tolerances: counts (confusion matrices, match counts, tp/fp/fn/tn) are
compared exactly; every float (per-class and pooled precision, recall,
F1, accuracy, AP, mAP, tuned thresholds, curve points) within 1e-12, since
both sides run the same float64 numpy arithmetic. The port's numpy
``precision_recall_curve`` and ``average_precision_score`` are held to
sklearn's, which the JAX module calls, on ties, single-class and
zero-support inputs, within 1e-12.
"""

import numpy as np
import pytest
import sklearn.metrics as skm

import jax.numpy as jnp

from learning_embeddings_tpu.eval import metrics as jm
from learning_embeddings_tpu.eval import multilabel as jml
from learning_embeddings_tpu.eval.reports import Summarize as JaxSummarize
from learning_embeddings_tpu.hierarchy import toy_labelmap as jax_toy
from learning_embeddings_tpu_torch.eval import metrics as tm
from learning_embeddings_tpu_torch.eval import multilabel as tml
from learning_embeddings_tpu_torch.eval.reports import Summarize
from learning_embeddings_tpu_torch.hierarchy import toy_labelmap

TOL = 1e-12


def _close(a, b, path="out"):
    """Recursive equality of two metric results: numbers within TOL,
    arrays elementwise, dicts and lists by key and position."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif hasattr(a, "__dataclass_fields__"):
        _close(vars(a), vars(b), path)
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=0,
                                   atol=TOL, err_msg=path)


def _scores(seed, n, n_classes, ties=False):
    rng = np.random.RandomState(seed)
    s = rng.randn(n, n_classes).astype(np.float32)
    if ties:   # few distinct values: long runs of tied scores
        s = np.round(s * 2) / 2
    return s


@pytest.mark.parametrize("seed", [0, 1])
def test_confusion_matrix_counts_equal_jax(seed):
    rng = np.random.RandomState(seed)
    pred, gt = rng.randint(0, 7, 200), rng.randint(0, 7, 200)
    got = tm.confusion_matrix(pred, gt, 7)
    ref = np.asarray(jm.confusion_matrix(jnp.asarray(pred),
                                         jnp.asarray(gt), 7))
    assert np.array_equal(got, ref) and got.sum() == 200


@pytest.mark.parametrize("degenerate", [False, True])
def test_level_metrics_equal_jax(degenerate):
    rng = np.random.RandomState(3)
    cm = rng.randint(0, 9, (6, 6)).astype(np.float64)
    if degenerate:   # a class with no support and no prediction
        cm[2, :] = 0
        cm[:, 2] = 0
    _close(tm.level_metrics_from_confusion(cm),
           jm.level_metrics_from_confusion(cm))


@pytest.mark.parametrize("override", [False, True])
def test_multilevel_metrics_and_matches_equal_jax(override):
    lm, jlm = toy_labelmap(3, 3), jax_toy(3, 3)
    rng = np.random.RandomState(5)
    n = 64
    scores = _scores(6, n, lm.n_classes)
    ll = lm.leaf_paths()[rng.randint(0, lm.levels[-1], n)]
    pred = (np.stack([rng.randint(0, k, n) for k in lm.levels], 1)
            if override else None)
    _close(tm.multilevel_metrics(scores, ll, lm, pred),
           jm.multilevel_metrics(scores, ll, jlm, pred))
    assert tm.hierarchical_match_counts(scores, ll, lm) == \
        jm.hierarchical_match_counts(scores, ll, jlm)


CURVE_CASES = {
    "random": (np.random.RandomState(0).rand(50),
               np.random.RandomState(1).randint(0, 2, 50)),
    "ties": (np.array([0.9, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5]),
             np.array([1, 1, 0, 0, 0, 0, 0, 0, 0, 0])),
    "all_tied": (np.full(8, 0.3), np.array([1, 0, 1, 0, 0, 1, 0, 0])),
    "all_positive": (np.array([0.2, 0.7, 0.7, 0.1]), np.ones(4)),
    "one_sample": (np.array([0.4]), np.array([1])),
    "f32_ties": (np.round(np.random.RandomState(2).randn(300)
                          .astype(np.float32) * 4) / 4,
                 np.random.RandomState(3).randint(0, 2, 300)
                 .astype(np.float32)),
}


@pytest.mark.parametrize("case", sorted(CURVE_CASES))
def test_pr_curve_and_ap_equal_sklearn(case):
    s, y = CURVE_CASES[case]
    p, r, t = tml.precision_recall_curve(y, s)
    sp, sr, st = skm.precision_recall_curve(y, s)
    assert p.shape == sp.shape and r.shape == sr.shape and t.shape == st.shape
    for a, b in ((p, sp), (r, sr), (t, st)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    assert t.dtype == st.dtype
    assert abs(tml.average_precision_score(y, s)
               - skm.average_precision_score(y, s)) <= TOL


@pytest.mark.parametrize("ties", [False, True])
def test_per_class_pr_and_thresholds_equal_jax(ties):
    lm, jlm = toy_labelmap(2, 3), jax_toy(2, 3)
    rng = np.random.RandomState(7)
    n = 40
    scores = _scores(8, n, lm.n_classes, ties=ties)
    mh = (rng.rand(n, lm.n_classes) < 0.3).astype(np.float32)
    mh[:, 4] = 0            # a zero-support class: empty curves, AP 0
    mh[:, 5] = 1            # an all-positive class
    got, got_map = tml.per_class_pr(scores, mh)
    ref, ref_map = jml.per_class_pr(scores, mh)
    _close(got, ref)
    assert abs(got_map - ref_map) <= TOL
    assert len(got[4][2]) == 0 and got[4][3] == 0.0
    th = tml.tune_per_class_thresholds(scores, mh)
    np.testing.assert_allclose(th, jml.tune_per_class_thresholds(scores, mh),
                               rtol=0, atol=TOL)
    t1 = tml.tune_single_threshold(scores, mh)
    assert abs(t1 - jml.tune_single_threshold(scores, mh)) <= TOL
    for thr in (th, t1, 0.0):
        _close(tml.multilabel_metrics(scores, mh, thr, lm),
               jml.multilabel_metrics(scores, mh, thr, jlm))


def test_single_threshold_handles_tied_scores():
    scores = np.array([[0.9, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5]])
    multihot = np.array([[1, 1, 0, 0, 0, 0, 0, 0, 0, 0]])
    assert tml.tune_single_threshold(scores, multihot) == 0.9


def test_renderers_write_their_plots(tmp_path):
    rng = np.random.RandomState(0)
    scores = rng.rand(30, 4)
    mh = (rng.rand(30, 4) < 0.4).astype(np.float32)
    mh[:, 2] = 0
    written, mAP = tml.render_pr_curves(scores, mh, list("abcd"),
                                        str(tmp_path / "pr"))
    assert len(written) == 3 and all(map(lambda p: p.endswith(".png"),
                                         written))
    assert abs(mAP - jml.per_class_pr(scores, mh)[1]) <= TOL
    out = tml.render_score_vs_freq(rng.rand(4), mh.sum(0),
                                   str(tmp_path / "f1.png"))
    assert (tmp_path / "f1.png").stat().st_size > 0 and out.endswith("png")


def test_summarize_writes_the_same_bytes(tmp_path):
    def write(cls, d):
        s = cls(str(d))
        s.make_heading("Summary", 2)
        s.make_text("text")
        s.make_text("point", bullet=True)
        s.make_hrule()
        s.make_image("a.png", "alt")
        s.make_table([[1, 0.5], ["x", 2.25]], ["a", "b"], ["r0", "r1"])
        s.make_table([[3, 4.0]], ["c", "d"])
        return open(s.path, "rb").read()

    assert write(Summarize, tmp_path / "t") == \
        write(JaxSummarize, tmp_path / "j")
