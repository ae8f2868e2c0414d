"""The port's eval against the JAX package on the CPU: threshold sweeps,
prf1_from_counts, the joint ranking metrics, graph reconstruction and the
joint edge metrics, each on the same embeddings.

Ranking sorts labels by energy, and the threshold sweep compares energies
with each other, so an ulp of difference between two implementations of E
can flip a tie. The inputs here are built so that the energies that are
compared are well separated (or exactly equal where ties are the point),
or both packages are given one shared E."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from learning_embeddings_tpu.eval import metrics as jax_metrics
from learning_embeddings_tpu.eval import ranking as jax_ranking
from learning_embeddings_tpu.eval import reconstruction as jax_recon
from learning_embeddings_tpu.eval import threshold as jax_threshold
from learning_embeddings_tpu.hierarchy import toy_labelmap as jax_toy
from learning_embeddings_tpu.losses import joint_sampling as jax_js
from learning_embeddings_tpu.train import joint as jax_joint
from learning_embeddings_tpu_torch.eval import metrics, ranking, threshold
from learning_embeddings_tpu_torch.eval import reconstruction
from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
from learning_embeddings_tpu_torch.losses import joint_sampling as js
from learning_embeddings_tpu_torch.train import joint

torch.set_num_threads(2)


def _assert_threshold_metrics_equal(got, ref):
    assert got._fields == ref._fields
    for name, a, b in zip(got._fields, got, ref):
        # both sides compute the same f32 expressions of the same counts
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("ties", [False, True])
def test_best_threshold_matches_jax(ties):
    rng = np.random.RandomState(0)
    e_pos = rng.gamma(1.0, 1.0, 50).astype(np.float32)
    e_neg = rng.gamma(3.0, 1.0, 400).astype(np.float32)
    if ties:   # many equal energies: the smallest best threshold wins
        e_pos = np.round(e_pos * 2) / 2
        e_neg = np.round(e_neg * 2) / 2
    got = threshold.best_threshold_metrics(torch.from_numpy(e_pos),
                                           torch.from_numpy(e_neg))
    ref = jax_threshold.best_threshold_metrics(jnp.asarray(e_pos),
                                               jnp.asarray(e_neg))
    _assert_threshold_metrics_equal(got, ref)
    t = float(got.threshold) + 0.25
    _assert_threshold_metrics_equal(
        threshold.threshold_metrics(e_pos, e_neg, t),
        jax_threshold.threshold_metrics(jnp.asarray(e_pos),
                                        jnp.asarray(e_neg), t))


def test_prf1_from_counts_matches_jax():
    rng = np.random.RandomState(1)
    tp = rng.randint(0, 5, 30)
    pred = tp + rng.randint(0, 3, 30)
    sup = tp + rng.randint(0, 3, 30)
    tp[:3] = pred[:3] = sup[:3] = 0     # degenerate classes
    for degenerate_one in (False, True):
        for a, b in zip(
                metrics.prf1_from_counts(tp, pred, sup, degenerate_one),
                jax_metrics.prf1_from_counts(tp, pred, sup,
                                             degenerate_one)):
            np.testing.assert_array_equal(a, b)


def _separated_embeddings(lm, n_img, seed, d=8):
    """Label and image embeddings whose order energies are multiples of
    1/4 apart at least (integer-valued coordinates / 2: every energy is an
    exact multiple of 1/4 in f32 on both sides, so ties are exact ties)."""
    rng = np.random.RandomState(seed)
    lab = rng.randint(-4, 5, (lm.n_classes, d)).astype(np.float32) / 2
    img = rng.randint(-4, 5, (n_img, d)).astype(np.float32) / 2
    paths = (lm.leaf_paths()[rng.randint(0, lm.levels[-1], n_img)]
             + np.asarray(lm.level_start)[None, :]).astype(np.int32)
    return lab, img, paths


@pytest.mark.parametrize("energy", ["order", "euc_cone"])
def test_joint_classification_metrics_match_jax(energy, monkeypatch):
    lm, jlm = toy_labelmap(3, 3), jax_toy(3, 3)
    lab, img, paths = _separated_embeddings(lm, 60, seed=2)
    kw = {} if energy == "order" else {"K": 3.0}
    if energy != "order":
        # a cone energy is not exact on the grid: give both one shared E
        E = np.array(jax_ranking.pairwise_energy_sharded(
            energy, jnp.asarray(lab), jnp.asarray(img), **kw))
        monkeypatch.setattr(ranking, "pairwise_energy",
                            lambda kind, u, v, **k: torch.from_numpy(E))
        monkeypatch.setattr(jax_ranking, "pairwise_energy_sharded",
                            lambda kind, u, v, mesh=None, **k:
                            jnp.asarray(E))
    got = ranking.joint_classification_metrics(
        torch.from_numpy(lab), img, paths, lm, energy=energy, **kw)
    ref = jax_ranking.joint_classification_metrics(
        jnp.asarray(lab), img, paths, jlm, energy=energy, **kw)
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got.pop("top1_per_level"),
                                  ref.pop("top1_per_level"))
    for k, v in ref.items():
        assert got[k] == pytest.approx(v, rel=1e-6), k


@pytest.mark.parametrize("fixed", [False, True])
def test_reconstruction_matches_jax(fixed):
    lm = toy_labelmap(3, 3)
    lab, _, _ = _separated_embeddings(lm, 1, seed=3)
    g, _ = js.build_joint_graph(lm, lm.leaf_paths())
    jg, _ = jax_js.build_joint_graph(jax_toy(3, 3), lm.leaf_paths())
    thr = 1.0 if fixed else None
    got = reconstruction.reconstruction_metrics(
        torch.from_numpy(lab), g.label_closure, energy="order",
        threshold=thr)
    ref = jax_recon.reconstruction_metrics(
        jnp.asarray(lab), jg.label_closure, energy="order", threshold=thr)
    _assert_threshold_metrics_equal(got, ref)


@pytest.mark.parametrize("energy", ["order", "euc_cone"])
def test_joint_edge_metrics_match_jax(energy):
    lm = toy_labelmap(3, 3)
    ll = lm.leaf_paths()[np.random.RandomState(4).randint(0, 27, 50)]
    g, _ = js.build_joint_graph(lm, ll)
    jg, _ = jax_js.build_joint_graph(jax_toy(3, 3), ll)
    lab, img, paths = _separated_embeddings(lm, 12, seed=5)
    kw = {} if energy == "order" else {"K": 3.0}
    common = dict(energy=energy, neg_to_pos_ratio=3, pick_per_level=True,
                  seed=17, **kw)
    got = joint.joint_edge_metrics(torch.from_numpy(lab), img, paths, g,
                                   **common)
    ref = jax_joint.joint_edge_metrics(lab, img, paths, jg, **common)
    if energy == "order":
        _assert_threshold_metrics_equal(got, ref)
    else:   # cone energies are not on the grid: ulps may move the best
        #     threshold by a rounding step, never the metrics much
        assert float(got.f1) == pytest.approx(float(ref.f1), abs=1e-3)
        assert float(got.threshold) == pytest.approx(float(ref.threshold),
                                                     rel=1e-4, abs=1e-6)
    t = float(ref.threshold)
    got_t = joint.joint_edge_metrics(torch.from_numpy(lab), img, paths, g,
                                     threshold=t + 0.125, **common)
    ref_t = jax_joint.joint_edge_metrics(lab, img, paths, jg,
                                         threshold=t + 0.125, **common)
    _assert_threshold_metrics_equal(got_t, ref_t)
