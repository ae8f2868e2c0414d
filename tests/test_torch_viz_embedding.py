"""The port's embedding plots (``viz/contours.py``, ``viz/hypernymy.py``)
on the CPU, against the JAX package's: ``invert_embeddings`` within rel
1e-12 (the same float64 numpy), ``dot_product_reconstruction``'s F1,
threshold and counts equal (the same f32 energies and sweep rule), the
Voronoi region map equal; and each plot writes its file (matplotlib is
imported inside the functions)."""

import numpy as np
import pytest

from learning_embeddings_tpu.hierarchy import toy_labelmap as jax_toy
from learning_embeddings_tpu.viz import contours as jc
from learning_embeddings_tpu_torch.hierarchy import (butterfly200_labelmap,
                                                     toy_labelmap)
from learning_embeddings_tpu_torch.viz import contours as tc
from learning_embeddings_tpu_torch.viz.hypernymy import (
    plot_hierarchy_embedding)


def _vectors(n, seed=0):
    return np.random.RandomState(seed).randn(n, 2).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_invert_embeddings_equals_jax(scale):
    P = _vectors(40)
    P[3] = 0.0                       # a zero row: the norm floor
    got = tc.invert_embeddings(P, scale=scale)
    np.testing.assert_allclose(got, jc.invert_embeddings(P, scale=scale),
                               rtol=1e-12, atol=0)
    # a row of norm n goes to norm scale·max‖x‖/n along its direction
    keep = np.arange(40) != 3
    n = np.linalg.norm(P[keep], axis=1)
    np.testing.assert_allclose(np.linalg.norm(got[keep], axis=1),
                               scale * n.max() / n, rtol=1e-6)
    np.testing.assert_allclose(got[keep] / np.linalg.norm(
        got[keep], axis=1, keepdims=True), P[keep] / n[:, None], rtol=1e-6,
        atol=1e-7)


@pytest.mark.parametrize("branching,levels,seed", [(2, 3, 0), (3, 3, 1)])
def test_dot_product_reconstruction_equals_jax(branching, levels, seed):
    lm, jlm = toy_labelmap(branching, levels), jax_toy(branching, levels)
    P = _vectors(lm.n_classes, seed)
    got = tc.dot_product_reconstruction(P, lm)
    want = jc.dot_product_reconstruction(P, jlm)
    for k in ("f1", "accuracy", "precision", "recall", "correct_positives",
              "correct_negatives"):
        assert float(getattr(got, k)) == pytest.approx(
            float(getattr(want, k)), abs=1e-6), k
    assert float(got.threshold) == float(want.threshold)


def test_plots_write_their_files(tmp_path):
    lm = butterfly200_labelmap()
    P = _vectors(lm.n_classes)
    inv = tc.plot_inverted_embedding(P, lm, str(tmp_path / "a" / "inv.png"))
    np.testing.assert_allclose(inv, tc.invert_embeddings(P))
    region = tc.plot_dot_product_voronoi(_vectors(5).T,
                                         str(tmp_path / "vor.png"), res=64)
    W = _vectors(5)
    xs = np.linspace(-3.0, 3.0, 64)
    X, Y = np.meshgrid(xs, xs)
    want = np.argmax(np.stack([X.ravel(), Y.ravel()], 1) @ W.T,
                     1).reshape(64, 64)
    np.testing.assert_array_equal(region, want)
    np.testing.assert_array_equal(
        region, jc.plot_dot_product_voronoi(W, str(tmp_path / "j.png"),
                                            res=64))
    for energy, K in (("hyp_cone", 0.1), ("euc_cone", 3.0), ("order", None)):
        rng = np.random.RandomState(1)
        lab = rng.uniform(-0.7, 0.7, (lm.n_classes, 10))
        img = rng.uniform(-0.7, 0.7, (50, 10))
        path = tmp_path / f"h_{energy}.png"
        plot_hierarchy_embedding(lab, lm, str(path), img_emb=img,
                                 img_leaf_labels=rng.randint(0, 200, 50),
                                 energy=energy, K=K)
        assert path.stat().st_size > 1000
    for p in ("a/inv.png", "vor.png"):
        assert (tmp_path / p).stat().st_size > 1000
