"""The port's label-only embedding trainer against the JAX package's on the
CPU.

* Steps from injected negatives: the port's table starts as the JAX
  trainer's, and the JAX trainer's own jitted epoch runs one batch a step
  with a sampler that returns the same negatives the port's `train_step`
  gets. Over 5 steps the tables agree within abs 1e-6 after every step,
  the losses within rel 1e-5 and the energies within rel 1e-5 + abs 5e-5
  (the hyperbolic energy's tolerance in test_torch_geometry.py). The
  hyperbolic cases start from rows at norms 0.3-0.8, not from the
  initialisation's r0 + U[0, 0.05]: at the inner radius r0 the cone's
  half-aperture asin(K(1 − ‖x‖²)/‖x‖) has its argument at the clamp
  1 − 1e−5, its gradient reaches ~229, and f32 rounding of it differs by
  3e-5 relative between the two (measured), which one RSGD step at lr
  0.01 carries into the table as ~3e-6.
* The device sampler: only negative pairs, the per-level passes, the
  (B, 2R) layout, the fall-back to the whole row, and uniformity over
  each row's candidates by a chi-square test. Its draws cannot equal
  JAX's; it is held to the distribution and the layout.
* The toy end-to-end runs that reach reconstruction F1 1.0 (after
  tests/test_embedding_e2e.py), the val-threshold calibration and its
  reuse on test, the warm start's rescale, the edge splits (equal to the
  JAX package's), the weight helpers and the trainer's contracts.

  Whether a toy run converges is decided almost wholly by the table's
  random start: from the JAX package's seed-0 start the port converges as
  the JAX test does (test_order_reconstruction_from_the_jax_start). The
  port draws its own start from torch's generator, so the other runs use
  seeds at which that start converges (4 for the reconstructions, 3 for
  the threshold run), as the JAX tests use seed 0 for theirs.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from learning_embeddings_tpu.hierarchy import (
    label_graph_from_paths as jax_graph, split_edges as jax_split,
    toy_labelmap as jax_toy)
from learning_embeddings_tpu.losses import margin as jm
from learning_embeddings_tpu_torch.parallel.mesh import Mesh
from learning_embeddings_tpu.train.embedding import (
    EmbeddingTrainer as JaxTrainer,
    EmbeddingTrainerConfig as JaxConfig)
from learning_embeddings_tpu_torch.geometry import inner_radius
from learning_embeddings_tpu_torch.hierarchy import (
    butterfly200_labelmap, label_graph_from_paths, split_edges,
    toy_labelmap)
from learning_embeddings_tpu_torch.losses import margin as tm
from learning_embeddings_tpu_torch.models import label_table_from_jax
from learning_embeddings_tpu_torch.train.embedding import (
    EmbeddingTrainer, EmbeddingTrainerConfig)

torch.set_num_threads(2)

R0 = inner_radius(0.1)


def toy(branching=3, n_levels=3, **split_kw):
    lm = toy_labelmap(branching, n_levels)
    kw = dict(proportion_of_nb_edges_in_train=1.0, val_frac=0.0,
              test_frac=0.0)
    kw.update(split_kw)
    return lm, split_edges(label_graph_from_paths(lm.leaf_paths(), lm), **kw)


@pytest.fixture(scope="module")
def toy33():
    """toy(3, 3) on both sides, with val and test edges."""
    kw = dict(proportion_of_nb_edges_in_train=0.5, val_frac=0.15,
              test_frac=0.15, seed=0)
    lm, jlm = toy_labelmap(3, 3), jax_toy(3, 3)
    splits = split_edges(label_graph_from_paths(lm.leaf_paths(), lm), **kw)
    jsplits = jax_split(jax_graph(jlm.leaf_paths(), jlm), **kw)
    return lm, jlm, splits, jsplits


# ----------------------------------------------------------------------
# steps against the JAX trainer
# ----------------------------------------------------------------------
STEP_CASES = {
    "hyp_rsgd": dict(energy="hyp_cone", optimizer="rsgd", lr=0.1),
    "hyp_radam": dict(energy="hyp_cone", optimizer="radam", lr=0.01),
    "hyp_adam": dict(energy="hyp_cone", optimizer="adam", lr=0.01,
                     pick_per_level=True),
    "hyp_sgd": dict(energy="hyp_cone", optimizer="sgd", lr=0.1),
    "hyp_rsgd_lr_steps": dict(energy="hyp_cone", optimizer="rsgd", lr=0.1,
                              lr_steps=(1,), steps_per_epoch=2),
    "order_adam": dict(energy="order", optimizer="adam", lr=0.01),
    "order_sgd_lr_steps": dict(energy="order", optimizer="sgd", lr=0.01,
                               lr_steps=(1, 2), steps_per_epoch=2),
    "order_level_weights": dict(energy="order", optimizer="adam", lr=0.01,
                                level_weights=(1.0, 2.0, 3.0)),
    "order_weigh_pos_term": dict(energy="order", optimizer="adam", lr=0.01,
                                 level_weights=(1.0, 2.0, 3.0),
                                 weigh_pos_term=True),
    "order_weigh_neg_term": dict(energy="order", optimizer="sgd", lr=0.01,
                                 weigh_neg_term=True),
    "euc_cone_adam": dict(energy="euc_cone", optimizer="adam", lr=0.01,
                          alpha=0.1),
}


def make_pair(toy33, **kw):
    lm, jlm, splits, jsplits = toy33
    common = dict(embedding_dim=4, batch_size=10, neg_to_pos_ratio=3,
                  seed=0)
    common.update(kw)
    jt = JaxTrainer(jlm, jsplits, JaxConfig(donate=False, **common))
    if common.get("energy", "hyp_cone") == "hyp_cone":
        # rows away from the inner radius (see the module doc)
        rng = np.random.RandomState(2)
        x = rng.randn(*jt.params["params"]["embedding"].shape)
        x *= rng.uniform(0.3, 0.8, (len(x), 1)) / np.linalg.norm(
            x, axis=1, keepdims=True)
        jt.params = {"params": {"embedding": jnp.asarray(x, jnp.float32)}}
    pt = EmbeddingTrainer(lm, splits, EmbeddingTrainerConfig(
        device="cpu", **common))
    pt.model.load_state_dict(label_table_from_jax(jax.device_get(jt.params)))
    return jt, pt


def jax_step(jt, pf, pt_, nf, nt):
    """One step of the JAX trainer's own jitted epoch over one batch, its
    sampler replaced by one that returns (nf, nt)."""
    jt.sampler = jm.NegativeSampler(
        sample=lambda key, a, b: (jnp.asarray(nf), jnp.asarray(nt)),
        neg_to_pos_ratio=jt.cfg.neg_to_pos_ratio)
    epoch = jt._build_epoch_fn()
    jt.params, jt.opt_state, _, losses, e_pos, e_neg = epoch(
        jt.params, jt.opt_state, jax.random.PRNGKey(0),
        jnp.asarray(pf)[None], jnp.asarray(pt_)[None])
    return float(losses[0]), np.asarray(e_pos[0]), np.asarray(e_neg[0])


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_steps_from_injected_negatives_match_jax(toy33, case):
    jt, pt = make_pair(toy33, **STEP_CASES[case])
    sampler = jt.sampler
    edges = toy33[2].train
    rng = np.random.RandomState(1)
    for step in range(5):
        batch = edges[rng.permutation(len(edges))[:10]]
        pf, pt_ = batch[:, 0], batch[:, 1]
        nf, nt = map(np.asarray, sampler.sample(
            jax.random.PRNGKey(step), jnp.asarray(pf), jnp.asarray(pt_)))
        lj, epj, enj = jax_step(jt, pf, pt_, nf, nt)
        lp, epp, enp = pt.train_step(pf, pt_, nf, nt)
        assert float(lp) == pytest.approx(lj, rel=1e-5), step
        np.testing.assert_allclose(epp.numpy(), epj, rtol=1e-5, atol=5e-5)
        np.testing.assert_allclose(enp.numpy(), enj, rtol=1e-5, atol=5e-5)
        np.testing.assert_allclose(
            pt.model.embedding.detach().numpy(),
            np.asarray(jt.params["params"]["embedding"]), rtol=0, atol=1e-6,
            err_msg=f"step {step}")
    if STEP_CASES[case].get("lr_steps"):
        assert pt.optimizer.param_groups[0]["lr"] < STEP_CASES[case]["lr"]


def test_evaluate_matches_jax_on_the_same_negatives(toy33):
    jt, pt = make_pair(toy33, energy="hyp_cone", optimizer="adam", lr=0.01)
    for split in ("val", "test"):
        pt._eval_negatives[split] = jt._edge_set_with_negatives(split)
    for split in ("val", "test"):
        got, want = pt.evaluate(split), jt.evaluate(split)
        for name, a, b in zip(want._fields, got, want):
            assert float(a) == pytest.approx(float(b), rel=1e-5,
                                             abs=1e-6), (split, name)
    assert pt.optimal_threshold == pytest.approx(jt.optimal_threshold,
                                                 rel=1e-6)
    got, want = pt.reconstruction(), jt.reconstruction()
    for name, a, b in zip(want._fields, got, want):
        assert float(a) == pytest.approx(float(b), rel=1e-5, abs=1e-6), name


@pytest.mark.parametrize("energy", ["hyp_cone", "order"])
def test_load_embedding_table_matches_jax(toy33, energy):
    jt, pt = make_pair(toy33, energy=energy, optimizer="adam")
    table = np.random.RandomState(3).randn(pt.n_nodes, 4).astype(np.float32)
    jt.load_embedding_table(2.0 * table)
    pt.load_embedding_table(2.0 * table)
    got = pt.model.embedding.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(
        jt.params["params"]["embedding"]), rtol=1e-6, atol=1e-7)
    if energy == "hyp_cone":   # norms mapped onto [r0, 1 − r0]
        norms = np.linalg.norm(got, axis=1)
        assert norms.max() == pytest.approx(1 - R0, rel=1e-6)
        assert norms.min() >= R0 - 1e-6
    else:
        np.testing.assert_array_equal(got, 2.0 * table)


# ----------------------------------------------------------------------
# the device sampler
# ----------------------------------------------------------------------
def _port_sampler(splits, lm, R, pick_per_level):
    return tm.make_negative_sampler(
        splits.negatives, R, level_start=lm.level_start,
        level_stop=lm.level_stop, pick_per_level=pick_per_level)


@pytest.mark.parametrize("pick_per_level", [False, True])
def test_sampler_draws_negatives_in_the_layout(pick_per_level):
    lm, splits = toy(3, 3)
    R = 4
    sampler = _port_sampler(splits, lm, R, pick_per_level)
    edges = torch.from_numpy(splits.train.astype(np.int64))
    gen = torch.Generator().manual_seed(0)
    nf, nt = sampler.sample(gen, edges[:, 0], edges[:, 1])
    B = len(edges)
    assert nf.shape == nt.shape == (B * 2 * R,)
    nf, nt = nf.numpy(), nt.numpy()
    assert splits.negatives[nf, nt].all(), "sampled a non-negative pair"
    # slots 2R·i + r keep u_i, slots 2R·i + R + r keep v_i
    nf2, nt2 = nf.reshape(B, 2 * R), nt.reshape(B, 2 * R)
    e = splits.train
    np.testing.assert_array_equal(nf2[:, :R], np.repeat(e[:, :1], R, 1))
    np.testing.assert_array_equal(nt2[:, R:], np.repeat(e[:, 1:], R, 1))
    if pick_per_level:   # the corrupted node of pass r is at level r % L
        lvl = lm.level_of_global()
        for r in range(R):
            assert (lvl[nt2[:, r]] == r % lm.n_levels).all()
            assert (lvl[nf2[:, R + r]] == r % lm.n_levels).all()


def test_sampler_is_uniform_over_candidates():
    """Chi-square of 6000 corrupted-to draws of one positive (root 0 →
    its first child) against the uniform distribution over node 0's
    negative candidates, and the same for the corrupted-from side."""
    lm, splits = toy(3, 2)   # 3 + 9 labels
    sampler = _port_sampler(splits, lm, 1, False)
    n = 6000
    gen = torch.Generator().manual_seed(0)
    nf, nt = sampler.sample(gen, torch.zeros(n, dtype=torch.int64),
                            torch.full((n,), 3, dtype=torch.int64))
    for drawn, cands in (
            (nt.numpy().reshape(n, 2)[:, 0],
             np.nonzero(splits.negatives[0])[0]),
            (nf.numpy().reshape(n, 2)[:, 1],
             np.nonzero(splits.negatives[:, 3])[0])):
        counts = np.bincount(drawn, minlength=lm.n_classes)
        assert counts.sum() == counts[cands].sum() == n
        p = stats.chisquare(counts[cands]).pvalue
        assert p > 1e-3, (counts[cands], p)


def test_masked_categorical_falls_back_to_the_whole_row():
    mask = torch.zeros((2000, 5), dtype=torch.bool)
    mask[:1000, 2] = True                  # one candidate: always 2
    gen = torch.Generator().manual_seed(1)
    got = tm.masked_uniform_categorical(gen, mask).numpy()
    assert (got[:1000] == 2).all()
    counts = np.bincount(got[1000:], minlength=5)   # empty rows: uniform
    assert stats.chisquare(counts).pvalue > 1e-3, counts


def test_sampler_per_level_fall_back_to_the_whole_row():
    """A pass whose level holds no candidate draws uniformly from the
    whole row, every node (the JAX sampler's fall-back); a pass with one
    candidate always draws it."""
    negatives = np.zeros((4, 4), bool)
    negatives[0, 3] = True                 # the only negative pair: (0, 3)
    sampler = tm.make_negative_sampler(
        negatives, 2, level_start=np.array([0, 2]),
        level_stop=np.array([2, 4]), pick_per_level=True)
    n = 4000
    gen = torch.Generator().manual_seed(0)
    nf, nt = sampler.sample(gen, torch.zeros(n, dtype=torch.int64),
                            torch.full((n,), 3, dtype=torch.int64))
    nf, nt = nf.numpy().reshape(n, 4), nt.numpy().reshape(n, 4)
    # corrupted 'to' of node 0: pass 0 (level {0, 1}) has no candidate,
    # pass 1 (level {2, 3}) has 3; corrupted 'from' of node 3: pass 0
    # has 0, pass 1 none
    assert (nt[:, 1] == 3).all() and (nf[:, 2] == 0).all()
    for drawn in (nt[:, 0], nf[:, 3]):
        counts = np.bincount(drawn, minlength=4)
        assert stats.chisquare(counts).pvalue > 1e-3, counts


# ----------------------------------------------------------------------
# weight helpers
# ----------------------------------------------------------------------
def test_level_weights_for_nodes_matches_jax():
    lm = toy_labelmap(3, 3)
    nodes = np.array([0, 2, 3, 11, 12, 38, 39, 50])   # 39+: past the levels
    lw = (1.0, 2.0, 3.0)
    got = tm.level_weights_for_nodes(torch.from_numpy(nodes), lm.level_stop,
                                     lw)
    want = jm.level_weights_for_nodes(jnp.asarray(nodes), lm.level_stop, lw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_degree_neg_weights_matches_jax():
    R, n_nodes = 2, 10
    in_deg = np.array([0, 1, 2, 4] + [1] * 6)
    out_deg = np.array([5, 0, 1, 2] + [1] * 6)
    nf, nt = np.array([7, 7, 0, 1, 3, 3, 2, 9]), np.array([2, 0, 8, 8,
                                                           1, 3, 5, 5])
    got = tm.degree_neg_weights(*map(torch.from_numpy,
                                     (nf, nt, in_deg, out_deg)), R, n_nodes)
    want = jm.degree_neg_weights(nf, nt, jnp.asarray(in_deg),
                                 jnp.asarray(out_deg), R, n_nodes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)


@pytest.mark.parametrize("energy", ["order", "hyp_cone"])
def test_eval_edge_energies_matches_jax(energy):
    rng = np.random.RandomState(4)
    x = (0.3 * rng.randn(2, 12, 4)).astype(np.float32)
    status = rng.randint(0, 2, 12)
    got = tm.eval_edge_energies(*map(torch.from_numpy, (x[0], x[1], status)),
                                energy=energy, alpha=0.2)
    want = jm.eval_edge_energies(jnp.asarray(x[0]), jnp.asarray(x[1]),
                                 jnp.asarray(status), energy=energy,
                                 alpha=0.2)
    assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


# ----------------------------------------------------------------------
# edge splits
# ----------------------------------------------------------------------
@pytest.mark.parametrize("taxonomy,kw", [
    ("toy", dict(proportion_of_nb_edges_in_train=1.0, val_frac=0.0,
                 test_frac=0.0)),
    ("toy", dict(proportion_of_nb_edges_in_train=0.5, val_frac=0.15,
                 test_frac=0.15, seed=3)),
    ("butterfly200", dict(proportion_of_nb_edges_in_train=0.9)),
    ("butterfly200", dict(seed=7))])
def test_split_edges_equal_jax(taxonomy, kw):
    from learning_embeddings_tpu.hierarchy import butterfly200_labelmap as jb

    if taxonomy == "toy":
        lm, jlm = toy_labelmap(3, 3), jax_toy(3, 3)
    else:
        lm, jlm = butterfly200_labelmap(), jb()
    got = split_edges(label_graph_from_paths(lm.leaf_paths(), lm), **kw)
    want = jax_split(jax_graph(jlm.leaf_paths(), jlm), **kw)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


# ----------------------------------------------------------------------
# end to end on a toy taxonomy
# ----------------------------------------------------------------------
def _train(lm, splits, cfg, epochs):
    tr = EmbeddingTrainer(lm, splits, cfg)
    rng = np.random.RandomState(0)
    for _ in range(epochs):
        stats_ = tr.train_epoch(rng)
    return tr, stats_


def test_order_embedding_perfect_reconstruction():
    lm, splits = toy(2, 3)
    cfg = EmbeddingTrainerConfig(energy="order", embedding_dim=4, lr=0.01,
                                 batch_size=10, neg_to_pos_ratio=5,
                                 alpha=1.0, optimizer="adam", seed=4,
                                 device="cpu")
    tr, st = _train(lm, splits, cfg, 300)
    assert float(tr.reconstruction().f1) == 1.0
    assert st["e_pos_mean"] < 0.05


def test_order_reconstruction_from_the_jax_start():
    """The JAX package's toy order run (tests/test_embedding_e2e.py, seed
    0) started from the JAX trainer's table: the port, with its own
    negatives, reaches F1 1.0 as well."""
    lm, splits = toy(2, 3)
    kw = dict(energy="order", embedding_dim=4, lr=0.01, batch_size=10,
              neg_to_pos_ratio=5, alpha=1.0, optimizer="adam", seed=0)
    jlm = jax_toy(2, 3)
    jt = JaxTrainer(jlm, jax_split(jax_graph(jlm.leaf_paths(), jlm),
                                   proportion_of_nb_edges_in_train=1.0,
                                   val_frac=0.0, test_frac=0.0),
                    JaxConfig(donate=False, **kw))
    tr = EmbeddingTrainer(lm, splits, EmbeddingTrainerConfig(device="cpu",
                                                             **kw))
    tr.model.load_state_dict(label_table_from_jax(jax.device_get(jt.params)))
    rng = np.random.RandomState(0)
    for _ in range(300):
        st = tr.train_epoch(rng)
    assert float(tr.reconstruction().f1) == 1.0
    assert st["e_pos_mean"] < 0.05


def test_hyp_cone_embedding_perfect_reconstruction():
    lm, splits = toy(2, 3)
    cfg = EmbeddingTrainerConfig(energy="hyp_cone", embedding_dim=2,
                                 lr=0.03, batch_size=10, neg_to_pos_ratio=5,
                                 alpha=0.01, optimizer="adam",
                                 pick_per_level=True, seed=4, device="cpu")
    tr, _ = _train(lm, splits, cfg, 400)
    assert float(tr.reconstruction().f1) == 1.0
    # the hybrid path keeps the embeddings inside the annulus
    norms = np.linalg.norm(tr.all_embeddings().numpy(), axis=1)
    assert (norms <= 1.0 - 1e-6).all() and (norms >= R0 - 1e-6).all()


def test_val_threshold_calibration_and_test_reuse():
    lm, splits = toy(3, 3, proportion_of_nb_edges_in_train=0.5,
                     val_frac=0.15, test_frac=0.15, seed=0)
    assert len(splits.val) > 0 and len(splits.test) > 0
    cfg = EmbeddingTrainerConfig(energy="order", embedding_dim=4, lr=0.01,
                                 batch_size=10, neg_to_pos_ratio=3,
                                 alpha=1.0, optimizer="adam", seed=3,
                                 device="cpu")
    tr, _ = _train(lm, splits, cfg, 400)
    # before val, test sweeps its own threshold and stores none
    tr.evaluate("test")
    assert tr.optimal_threshold is None
    val = tr.evaluate("val")
    assert tr.optimal_threshold == float(val.threshold)
    test = tr.evaluate("test")
    assert float(test.threshold) == pytest.approx(tr.optimal_threshold)
    # the same negatives every call
    assert tr._edge_set_with_negatives("val") is \
        tr._edge_set_with_negatives("val")
    assert float(val.f1) > 0.8 and float(test.f1) > 0.4


# ----------------------------------------------------------------------
# contracts
# ----------------------------------------------------------------------
def test_checkpoint_payload_round_trip():
    lm, splits = toy(2, 3)
    cfg = EmbeddingTrainerConfig(energy="hyp_cone", optimizer="radam",
                                 lr=0.01, embedding_dim=3, lr_steps=(1,),
                                 device="cpu")
    tr = EmbeddingTrainer(lm, splits, cfg)
    assert tr.checkpoint_payload()["optimal_threshold"] != \
        tr.checkpoint_payload()["optimal_threshold"]   # NaN: none yet
    tr.train_epoch(np.random.RandomState(0))
    tr.optimal_threshold = 0.0
    fresh = EmbeddingTrainer(lm, splits, dataclasses.replace(cfg, seed=1))
    fresh.restore_payload(tr.checkpoint_payload())
    assert fresh.optimal_threshold == 0.0
    assert fresh.optimizer.param_groups[0]["lr"] == \
        tr.optimizer.param_groups[0]["lr"]
    edges = splits.train[:4]
    nf, nt = edges[[1, 2, 3, 0]].T
    a = tr.train_step(edges[:, 0], edges[:, 1], nf, nt)[0]
    b = fresh.train_step(edges[:, 0], edges[:, 1], nf, nt)[0]
    assert float(a) == float(b)
    assert torch.equal(tr.model.embedding, fresh.model.embedding)


def test_train_epoch_persists_its_rng_and_is_seeded():
    lm, splits = toy(2, 3)
    cfg = EmbeddingTrainerConfig(energy="order", optimizer="adam", lr=0.01,
                                 embedding_dim=3, device="cpu")
    a, b = EmbeddingTrainer(lm, splits, cfg), EmbeddingTrainer(lm, splits,
                                                               cfg)
    runs = [[t.train_epoch() for _ in range(2)] for t in (a, b)]
    assert runs[0] == runs[1]
    assert runs[0][0] != runs[0][1]
    assert torch.equal(a.model.embedding, b.model.embedding)


def test_hyperbolic_init_row_norms():
    lm, splits = toy(3, 3)
    tr = EmbeddingTrainer(lm, splits, EmbeddingTrainerConfig(
        optimizer="rsgd", device="cpu"))
    norms = tr.model.embedding.detach().norm(dim=1).numpy()
    assert tr.model.embedding.shape == (39, 10)
    assert (norms >= R0 - 1e-6).all() and (norms <= R0 + 0.05 + 1e-6).all()


@pytest.mark.parametrize("kw,err,match", [
    (dict(energy="order", optimizer="rsgd"), ValueError, "hyperbolic"),
    (dict(energy="euc_cone", optimizer="radam"), ValueError, "hyperbolic"),
    (dict(optimizer="lamb"), ValueError, "unknown optimizer"),
])
def test_invalid_options_raise(kw, err, match):
    lm, splits = toy(2, 3)
    with pytest.raises(err, match=match):
        EmbeddingTrainer(lm, splits, EmbeddingTrainerConfig(device="cpu",
                                                            **kw))


def test_mesh_and_missing_card_raise():
    """A mesh must be a parallel.mesh.Mesh (meshed runs:
    tests/test_torch_mesh_joint.py); a batch that does not shard raises."""
    lm, splits = toy(2, 3)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        EmbeddingTrainer(lm, splits, EmbeddingTrainerConfig(device="cpu"),
                         mesh=object())
    with pytest.raises(ValueError, match="divide evenly"):
        EmbeddingTrainer(lm, splits, EmbeddingTrainerConfig(
            device="cpu", batch_size=3), mesh=Mesh(2, 1, "cpu"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        EmbeddingTrainer(lm, splits, EmbeddingTrainerConfig())
