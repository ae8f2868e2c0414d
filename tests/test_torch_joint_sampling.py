"""The port's joint-graph building, host negative sampler, curriculum
helpers and margin losses against the JAX package on the CPU. The sampler
is numpy in both packages: the same RandomState must give the same
draws."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from learning_embeddings_tpu.hierarchy import graph as jax_graph
from learning_embeddings_tpu.hierarchy import toy_labelmap as jax_toy
from learning_embeddings_tpu.losses import joint_sampling as jax_js
from learning_embeddings_tpu.losses import margin as jax_margin
from learning_embeddings_tpu.train import joint as jax_joint
from learning_embeddings_tpu_torch.hierarchy import graph, toy_labelmap
from learning_embeddings_tpu_torch.losses import joint_sampling as js
from learning_embeddings_tpu_torch.losses import margin
from learning_embeddings_tpu_torch.train import joint

torch.set_num_threads(2)


def _graphs(n_img=40, seed=0):
    """The same train split through both packages' build_joint_graph."""
    lm, jlm = toy_labelmap(3, 3), jax_toy(3, 3)
    rng = np.random.RandomState(seed)
    ll = lm.leaf_paths()[rng.randint(0, lm.levels[-1], n_img)]
    return (lm, *js.build_joint_graph(lm, ll),
            *jax_js.build_joint_graph(jlm, ll))


def test_graph_helpers_match_jax():
    lm, jlm = toy_labelmap(3, 3), jax_toy(3, 3)
    rng = np.random.RandomState(1)
    ll = lm.leaf_paths()[rng.randint(0, lm.levels[-1], 30)]
    basic = graph.label_graph_from_paths(ll, lm)
    np.testing.assert_array_equal(
        basic, jax_graph.label_graph_from_paths(ll, jlm))
    np.testing.assert_array_equal(graph.transitive_closure(basic),
                                  jax_graph.transitive_closure(basic))


def test_build_joint_graph_matches_jax():
    _, g, edges, jg, jedges = _graphs()
    for a, b in zip(g, jg):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(edges, jedges)
    assert g.n_labels == jg.n_labels and g.n_images == jg.n_images


@pytest.mark.parametrize("pick_per_level,hide,ratio", [
    (True, (), 5), (False, (), 3), (True, (1,), 4), (True, (0, 2), 6)],
    ids=["per_level", "unrestricted", "hide_1", "hide_0_2"])
def test_sampler_gives_the_same_draws(pick_per_level, hide, ratio):
    _, g, edges, jg, _ = _graphs()
    stage = js.filter_stage_edges(g, edges, hide)
    np.testing.assert_array_equal(
        stage, jax_js.filter_stage_edges(jg, edges, hide))
    pf, pt = stage[:25, 0], stage[:25, 1]
    got = js.sample_joint_negatives_np(
        g, ratio, np.random.RandomState(3), pf, pt,
        pick_per_level=pick_per_level, levels_to_hide=hide)
    ref = jax_js.sample_joint_negatives_np(
        jg, ratio, np.random.RandomState(3), pf, pt,
        pick_per_level=pick_per_level, levels_to_hide=hide)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert not g.positive_mask(*got).any()


def test_sampler_widen_and_raise_match_jax():
    # every image descends from label 0: its image-level pass is empty
    lm = toy_labelmap(2, 2)
    ll = lm.leaf_paths()[[0, 1, 0, 1]]
    g, _ = js.build_joint_graph(lm, ll)
    jg, _ = jax_js.build_joint_graph(jax_toy(2, 2), ll)
    pf = np.array([0, 0, 2], np.int32)
    pt = np.array([lm.n_classes, lm.n_classes + 1, lm.n_classes + 2],
                  np.int32)
    got = js.sample_joint_negatives_np(g, 3, np.random.RandomState(5), pf,
                                       pt, empty_image_complement="widen")
    ref = jax_js.sample_joint_negatives_np(jg, 3, np.random.RandomState(5),
                                           pf, pt,
                                           empty_image_complement="widen")
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="ancestor of every image"):
        js.sample_joint_negatives_np(g, 3, np.random.RandomState(5), pf, pt)
    with pytest.raises(ValueError, match="leaves no training"):
        js.filter_stage_edges(g, np.array([[0, 1]], np.int32), (0,))


def test_save_and_load_joint_graph(tmp_path):
    _, g, edges, _, _ = _graphs()
    path = str(tmp_path / "graph.npz")
    js.save_joint_graph(path, g, edges)
    g2, edges2 = js.load_joint_graph(path)
    for a, b in zip(g, g2):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(edges, edges2)
    g3, _ = jax_js.load_joint_graph(path)   # the same file format
    np.testing.assert_array_equal(g3.image_paths_global,
                                  g.image_paths_global)


@pytest.mark.parametrize("half_half", [False, True])
def test_epoch_edge_order_matches_jax(half_half):
    _, g, edges, jg, _ = _graphs()
    np.testing.assert_array_equal(
        joint.epoch_edge_order(g, edges, np.random.RandomState(2),
                               half_half),
        jax_joint.epoch_edge_order(jg, edges, np.random.RandomState(2),
                                   half_half))


def test_curriculum_matches_jax():
    assert joint.DEFAULT_CURRICULUM == jax_joint.DEFAULT_CURRICULUM
    assert joint.JOINT_MODE == jax_joint.JOINT_MODE
    assert joint.DEFAULT_K == jax_joint.DEFAULT_K
    for epoch in (0, 19, 20, 49, 50, 99, 100, 1000):
        assert (joint.curriculum_levels_for_epoch(joint.DEFAULT_CURRICULUM,
                                                  epoch)
                == jax_joint.curriculum_levels_for_epoch(
                    jax_joint.DEFAULT_CURRICULUM, epoch))


VARIANTS = [("margin", "order"), ("margin", "euc_cone"),
            ("vendrov", "order"), ("vendrov", "euc_cone"), ("nll", "order")]


@pytest.mark.parametrize("variant,energy", VARIANTS)
def test_variant_losses_match_jax(variant, energy):
    rng = np.random.RandomState(4)
    B, R, d = 6, 3, 5
    embs = [rng.randn(n, d).astype(np.float32) * 2
            for n in (B, B, 2 * R * B, 2 * R * B)]
    kw = {} if energy == "order" else {"K": 3.0}
    loss, (ep, en) = margin.variant_loss(
        variant, *map(torch.from_numpy, embs), energy=energy, alpha=0.5,
        neg_to_pos_ratio=R, **kw)
    jloss, (jep, jen) = jax_margin.variant_loss(
        variant, *map(jnp.asarray, embs), energy=energy, alpha=0.5,
        neg_to_pos_ratio=R, **kw)
    # sums of f32 terms in another order
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(ep.numpy(), np.asarray(jep), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(en.numpy(), np.asarray(jen), rtol=1e-5,
                               atol=1e-6)


def test_margin_loss_weights_match_jax():
    rng = np.random.RandomState(8)
    embs = [rng.randn(n, 4).astype(np.float32) for n in (5, 5, 20, 20)]
    pw = rng.rand(5).astype(np.float32)
    nw = rng.rand(20).astype(np.float32)
    loss, _ = margin.margin_loss(
        *map(torch.from_numpy, embs), energy="order", alpha=1.0,
        pos_weights=torch.from_numpy(pw), neg_weights=torch.from_numpy(nw))
    jloss, _ = jax_margin.margin_loss(
        *map(jnp.asarray, embs), energy="order", alpha=1.0,
        pos_weights=jnp.asarray(pw), neg_weights=jnp.asarray(nw))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
