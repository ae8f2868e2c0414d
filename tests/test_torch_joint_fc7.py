"""The port's fc7 joint trainer (``train/joint.py::JointEmbeddingTrainer``),
its device sampler (``losses/joint_sampling.py::make_joint_negative_sampler``),
its image projectors (``models/embedder.py::FeatNet``,
``MatrixApproximation``), ``train/runner.py::run_joint_embedding`` and the
fc7 path of the joint CLIs, on the CPU, against the JAX package.

* Projectors: JAX parameters carried across with
  ``models/jax_import.py::feat_net_from_jax``; outputs within rel 1e-5 /
  abs 1e-6 in the three joint modes, and their input gradients within
  rel 1e-4 of the largest entry.
* Sampler: held to the JAX sampler's invariants
  (tests/test_joint.py:51-183), not to its bits: only negatives, the
  image pass's type follows the anchor, the run-skip image draw is
  uniform over the complement (chi-square at a fixed seed), an empty
  complement raises and hiding its level is the remedy, hidden levels
  never appear, and each slot's support equals that of the port's numpy
  ``sample_joint_negatives_np`` over many draws.
* Trainer steps: 4 ``train_step``s on given negatives against the JAX
  trainer's own jitted epoch fed the same negatives (its sampler replaced
  by one that returns them), from the same parameters. The fc7 features
  are scaled so that FeatNet's outputs lie inside the Poincaré annulus.
  After every step: the loss within rel 3e-5, the label table and FeatNet
  within abs 2e-6, the energies within rel 1e-5 + abs 2e-5 (measured:
  7.4e-6, 4.5e-7, 9e-8, 4.7e-6 at most).
* Eval: classification metrics (hit rates and F1 exactly, norms rel
  1e-5), edge metrics and reconstruction (F1 within 1e-6) equal the JAX
  trainer's for the same parameters.
* Runner and CLIs: the JAX runner's metric tags and the JAX CLI's
  manifest keys (plus ``device``), resume with the best model kept, and
  ``oe_h`` / ``oe`` end to end on features that the port's
  ``cli/image_emb.py`` wrote.
"""

import os
import sys

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from learning_embeddings_tpu.cli import oe_h as j_oe_h
from learning_embeddings_tpu.hierarchy import toy_labelmap as jax_toy
from learning_embeddings_tpu.losses.joint_sampling import (
    build_joint_graph as jax_build_joint_graph)
from learning_embeddings_tpu.models import embedder as jemb
from learning_embeddings_tpu.train.joint import (
    JointEmbeddingTrainer as JaxTrainer, JointTrainerConfig as JaxConfig)
from learning_embeddings_tpu.train.runner import (
    run_joint_embedding as jax_run_joint_embedding)
from learning_embeddings_tpu_torch.cli import image_emb as t_emb
from learning_embeddings_tpu_torch.cli import oe as t_oe
from learning_embeddings_tpu_torch.cli import oe_h as t_oe_h
from learning_embeddings_tpu_torch.cli._joint_main import load_features
from learning_embeddings_tpu_torch.geometry import inner_radius
from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
from learning_embeddings_tpu_torch.losses.joint_sampling import (
    build_joint_graph, make_joint_negative_sampler,
    sample_joint_negatives_np)
from learning_embeddings_tpu_torch.models import (FeatNet,
                                                  MatrixApproximation,
                                                  feat_net_from_jax,
                                                  label_table_from_jax)
from learning_embeddings_tpu_torch.train.experiment import (Checkpointer,
                                                            read_manifest)
from learning_embeddings_tpu_torch.train.joint import (
    JointEmbeddingTrainer, JointTrainerConfig)
from learning_embeddings_tpu_torch.train.runner import run_joint_embedding

from test_torch_cli import png_split  # noqa: F401 (fixture)

torch.set_num_threads(2)

R0 = inner_radius(0.1)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The runners also log to tensorboard where it imports; here that
    import pulls in TensorFlow, so these tests keep to the jsonl mirror."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def setup():
    """toy(2, 3) (14 labels, 8 leaves), 6 images a leaf, separable 32-d
    features (a centre per leaf + noise, as tests/test_joint.py), on both
    sides."""
    rng = np.random.RandomState(0)
    lm, jlm = toy_labelmap(2, 3), jax_toy(2, 3)
    leaves = np.repeat(np.arange(lm.levels[-1]), 6)
    ll = lm.leaf_paths()[leaves]
    graph, edges = build_joint_graph(lm, ll)
    jgraph, jedges = jax_build_joint_graph(jlm, ll)
    np.testing.assert_array_equal(edges, jedges)
    centers = rng.randn(lm.levels[-1], 32) * 3
    feats = (centers[leaves] + 0.3 * rng.randn(len(leaves), 32)).astype(
        np.float32)
    paths = (ll + np.asarray(lm.level_start)[None, :]).astype(np.int32)
    return dict(lm=lm, jlm=jlm, graph=graph, jgraph=jgraph, edges=edges,
                feats=feats, paths=paths, leaves=leaves)


def _level_of(graph):
    lvl = np.full(graph.n_labels + graph.n_images, graph.n_levels)
    for l in range(graph.n_levels):
        lvl[graph.level_start[l]:graph.level_stop[l]] = l
    return lvl


def _ids(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int64)


# ----------------------------------------------------------------------
# FeatNet and MatrixApproximation
# ----------------------------------------------------------------------
MODES = [("euclidean", None), ("euc_cone", 3.0), ("hyp_cone_exp0", 0.1)]


@pytest.mark.parametrize("cls", ["FeatNet", "MatrixApproximation"])
@pytest.mark.parametrize("mode,K", MODES, ids=[m for m, _ in MODES])
def test_projectors_match_jax(cls, mode, K):
    rng = np.random.RandomState(0)
    x = (0.3 * rng.randn(7, 32)).astype(np.float32)
    jm = getattr(jemb, cls)(dim=10, mode=mode, K=K)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    if cls == "MatrixApproximation":   # away from the init's near-identity
        variables = jax.tree_util.tree_map(
            lambda p: p + 0.3 * jnp.asarray(rng.randn(*p.shape),
                                            jnp.float32), variables)
    pm = {"FeatNet": FeatNet, "MatrixApproximation": MatrixApproximation}[
        cls](32, 10, mode=mode, K=K)
    pm.load_state_dict(feat_net_from_jax(jax.device_get(variables)))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = pm(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    w = rng.randn(*want.shape).astype(np.float32)
    (got * torch.as_tensor(w)).sum().backward()
    gj = np.asarray(jax.grad(lambda a: jnp.sum(
        jm.apply(variables, a) * w))(jnp.asarray(x)))
    np.testing.assert_allclose(xt.grad.numpy(), gj, rtol=0,
                               atol=1e-4 * np.abs(gj).max())
    if mode == "hyp_cone_exp0":
        n = np.linalg.norm(got.detach().numpy(), axis=1)
        assert (n >= R0 - 1e-6).all() and (n <= 1 - 1e-5 + 1e-6).all()


def test_projector_init_follows_flax():
    """FeatNet: LeCun-normal kernel (std 1/√fan_in), zero bias;
    MatrixApproximation: diag 1, u and v ~ N(0, 0.01²); both drawn from
    the generator given."""
    fn = FeatNet(2048, 10, generator=torch.Generator().manual_seed(0))
    w = fn.fc1.weight.detach().numpy()
    assert w.std() == pytest.approx(1 / np.sqrt(2048), rel=0.05)
    assert not fn.fc1.bias.detach().any()
    again = FeatNet(2048, 10, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.fc1.weight, fn.fc1.weight)
    ma = MatrixApproximation(2048, 10,
                             generator=torch.Generator().manual_seed(0))
    assert torch.equal(ma.diag.detach(), torch.ones(10))
    assert ma.v.detach().std().item() == pytest.approx(0.01, rel=0.1)


# ----------------------------------------------------------------------
# the device sampler
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pick_per_level", [True, False])
def test_sampler_draws_only_negatives_in_the_layout(setup, pick_per_level):
    graph, edges = setup["graph"], setup["edges"]
    R = 4
    sampler = make_joint_negative_sampler(graph, R,
                                          pick_per_level=pick_per_level)
    nf, nt = sampler(torch.Generator().manual_seed(0), _ids(edges[:, 0]),
                     _ids(edges[:, 1]))
    B = len(edges)
    assert nf.shape == nt.shape == (B * 2 * R,) and nf.dtype == torch.int64
    nf, nt = nf.numpy(), nt.numpy()
    assert not graph.positive_mask(nf, nt).any()
    assert not (nf == nt).any()
    nf2, nt2 = nf.reshape(B, 2 * R), nt.reshape(B, 2 * R)
    np.testing.assert_array_equal(nf2[:, :R], np.repeat(edges[:, :1], R, 1))
    np.testing.assert_array_equal(nt2[:, R:], np.repeat(edges[:, 1:], R, 1))
    if pick_per_level:   # pass r draws at level r % (L + 1); L = images
        lvl = _level_of(graph)
        for r in range(R):
            is_img = edges[:, 1] >= graph.n_labels
            if r < graph.n_levels:
                assert (lvl[nt2[:, r]] == r).all()
                assert (lvl[nf2[:, R + r]] == r).all()
            else:
                assert (nt2[:, r] >= graph.n_labels).all()
                assert ((nf2[:, R + r] < graph.n_labels) == is_img).all()


def test_image_pass_type_follows_the_anchor(setup):
    """On the image pass a label anchor corrupts with an image, an image
    anchor with a label (the kept endpoint decides)."""
    graph, edges = setup["graph"], setup["edges"]
    nl, L = graph.n_labels, graph.n_levels
    R = L + 1
    sampler = make_joint_negative_sampler(graph, R, pick_per_level=True)
    img_edges = edges[edges[:, 1] >= nl][:8]
    lab_edges = edges[edges[:, 1] < nl][:8]
    for e in (img_edges, lab_edges):
        nf, nt = sampler(torch.Generator().manual_seed(3), _ids(e[:, 0]),
                         _ids(e[:, 1]))
        B = len(e)
        nt2 = nt.numpy().reshape(B, 2 * R)[:, :R]
        nf2 = nf.numpy().reshape(B, 2 * R)[:, R:]
        assert (nt2[:, L] >= nl).all()        # 'from' anchors are labels
        assert ((nf2[:, L] < nl) == (e[:, 1] >= nl)).all()


def test_run_skip_image_draw_is_uniform_over_the_complement(setup):
    graph, edges = setup["graph"], setup["edges"]
    nl, L = graph.n_labels, graph.n_levels
    R = L + 1
    sampler = make_joint_negative_sampler(graph, R, pick_per_level=True)
    for anchor in (0, 2, 6):     # a root, a level-1 and a leaf label
        n = 4000
        to = edges[(edges[:, 0] == anchor) & (edges[:, 1] >= nl)][0, 1]
        nf, nt = sampler(torch.Generator().manual_seed(7),
                         torch.full((n,), anchor, dtype=torch.int64),
                         torch.full((n,), int(to), dtype=torch.int64))
        rows = nt.numpy().reshape(n, 2 * R)[:, L] - nl
        assert (rows >= 0).all()
        descended = (graph.image_paths_global == anchor).any(axis=1)
        assert not descended[rows].any()
        compl = np.nonzero(~descended)[0]
        counts = np.bincount(rows, minlength=graph.n_images)[compl]
        assert counts.sum() == n
        p = stats.chisquare(counts).pvalue
        assert p > 1e-3, (anchor, counts, p)


def test_empty_image_complement_raises_and_hiding_is_the_remedy():
    lm = toy_labelmap(2, 3)
    graph, _ = build_joint_graph(lm, lm.leaf_paths()[np.zeros(6, int)])
    with pytest.raises(ValueError, match="ancestors of EVERY"):
        make_joint_negative_sampler(graph, 4, pick_per_level=True)
    # the unrestricted pass mixes labels in; a ratio too small for the
    # image pass never draws an image
    make_joint_negative_sampler(graph, 4, pick_per_level=False)
    make_joint_negative_sampler(graph, 2, pick_per_level=True)
    # an offender confined to one level: hiding that level legalises it
    graph2, _ = build_joint_graph(lm, lm.leaf_paths()[np.arange(8) % 4])
    with pytest.raises(ValueError, match="ancestors of EVERY"):
        make_joint_negative_sampler(graph2, 4, pick_per_level=True)
    make_joint_negative_sampler(graph2, 4, pick_per_level=True,
                                levels_to_hide=(0,))


def test_hidden_levels_never_appear(setup):
    graph, edges = setup["graph"], setup["edges"]
    sampler = make_joint_negative_sampler(graph, 6, pick_per_level=True,
                                          levels_to_hide=(1, 2))
    pf, pt = _ids(edges[:12, 0]), _ids(edges[:12, 1])
    nf, nt = sampler(torch.Generator().manual_seed(1), pf, pt)
    corrupted = np.concatenate([nf.numpy().reshape(12, 12)[:, 6:].ravel(),
                                nt.numpy().reshape(12, 12)[:, :6].ravel()])
    assert not np.isin(_level_of(graph)[corrupted], [1, 2]).any()


@pytest.mark.parametrize("pick_per_level,hidden", [
    (True, ()), (False, ()), (True, (1,))])
def test_candidate_sets_equal_the_numpy_samplers(setup, pick_per_level,
                                                 hidden):
    """Each slot's support over many draws (both samplers at fixed seeds)
    is the same set: the same candidate sets, pass cycle and layout."""
    graph, edges = setup["graph"], setup["edges"]
    nl = graph.n_labels
    lvl = _level_of(graph)
    keep = ~np.isin(lvl[edges[:, 0]], hidden) & ~np.isin(lvl[edges[:, 1]],
                                                         hidden)
    kept = edges[keep]
    # label → label edges where the stage has any, and label → image
    batch = np.concatenate([kept[kept[:, 1] < nl][::5][:3],
                            kept[kept[:, 1] >= nl][::17][:3]])
    assert (batch[:, 1] >= nl).sum() == 3
    R, n = 4, 1500
    pf = np.tile(batch[:, 0], n)
    pt = np.tile(batch[:, 1], n)
    sampler = make_joint_negative_sampler(graph, R,
                                          pick_per_level=pick_per_level,
                                          levels_to_hide=hidden)
    dev = [a.numpy().reshape(n, len(batch), 2 * R) for a in sampler(
        torch.Generator().manual_seed(0), _ids(pf), _ids(pt))]
    host = [a.reshape(n, len(batch), 2 * R) for a in
            sample_joint_negatives_np(
                graph, R, np.random.RandomState(0), pf, pt,
                pick_per_level=pick_per_level, levels_to_hide=hidden)]
    for i in range(len(batch)):
        for s in range(2 * R):
            side = 1 if s < R else 0       # the corrupted endpoint
            got = set(dev[side][:, i, s])
            want = set(host[side][:, i, s])
            assert got == want, (batch[i], s, sorted(got ^ want))


# ----------------------------------------------------------------------
# the trainer against the JAX trainer
# ----------------------------------------------------------------------
STEP_CASES = {
    "hyp_adam": dict(energy="hyp_cone", optimizer_labels="adam"),
    "hyp_rsgd": dict(energy="hyp_cone", optimizer_labels="rsgd"),
    "hyp_radam": dict(energy="hyp_cone", optimizer_labels="radam"),
    "hyp_vendrov": dict(energy="hyp_cone", loss_variant="vendrov"),
    "order_adam": dict(energy="order"),
    "order_vendrov": dict(energy="order", loss_variant="vendrov"),
    "order_nll": dict(energy="order", loss_variant="nll"),
    "euc_cone_adam": dict(energy="euc_cone"),
}
#: FeatNet's outputs of the 0.05-scaled features lie at norms 0.15-0.52
FEATURE_SCALE = 0.05


def make_pair(setup, feature_scale=FEATURE_SCALE, **kw):
    """The JAX and the port's trainer from the same parameters."""
    common = dict(embedding_dim=4, feature_dim=32, batch_size=12,
                  neg_to_pos_ratio=4, alpha=0.05, seed=0)
    common.update(kw)
    feats = setup["feats"] * feature_scale
    jt = JaxTrainer(setup["jlm"], setup["jgraph"], setup["edges"], feats,
                    JaxConfig(donate=False, **common))
    pt = JointEmbeddingTrainer(setup["lm"], setup["graph"], setup["edges"],
                               feats, JointTrainerConfig(device="cpu",
                                                         **common))
    p = jax.device_get(jt.params)
    pt.embedder.load_state_dict(label_table_from_jax(p["labels"]))
    pt.featnet.load_state_dict(feat_net_from_jax(p["images"]))
    return jt, pt


def jax_step(jt, pf, pt_, nf, nt):
    """One step of the JAX trainer's own jitted epoch over one batch, its
    sampler replaced by one that returns (nf, nt)."""
    epoch = jt._build_epoch_fn(
        lambda key, a, b: (jnp.asarray(nf), jnp.asarray(nt)))
    jt.params, jt.opt_state, losses, e_pos, e_neg = epoch(
        jt.params, jt.opt_state, jax.random.PRNGKey(0),
        jnp.asarray(pf)[None], jnp.asarray(pt_)[None])
    return float(losses[0]), np.asarray(e_pos[0]), np.asarray(e_neg[0])


def _same_params(jt, pt, what):
    np.testing.assert_allclose(
        pt.embedder.embedding.detach().numpy(),
        np.asarray(jt.params["labels"]["params"]["embedding"]), rtol=0,
        atol=2e-6, err_msg=what)
    fc1 = jt.params["images"]["params"]["fc1"]
    np.testing.assert_allclose(pt.featnet.fc1.weight.detach().numpy().T,
                               np.asarray(fc1["kernel"]), rtol=0,
                               atol=2e-6, err_msg=what)
    np.testing.assert_allclose(pt.featnet.fc1.bias.detach().numpy(),
                               np.asarray(fc1["bias"]), rtol=0, atol=2e-6,
                               err_msg=what)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_steps_from_given_negatives_match_jax(setup, case):
    jt, pt = make_pair(setup, **STEP_CASES[case])
    edges = setup["edges"]
    sampler = pt._stage(())[1]
    gen = torch.Generator().manual_seed(1)
    rng = np.random.RandomState(1)
    start = pt.embedder.embedding.detach().clone()
    for step in range(4):
        batch = edges[rng.permutation(len(edges))[:12]]
        pf, pt_ = batch[:, 0], batch[:, 1]
        nf, nt = (a.numpy() for a in sampler(gen, _ids(pf), _ids(pt_)))
        lj, epj, enj = jax_step(jt, pf, pt_, nf, nt)
        lp, epp, enp = pt.train_step(pf, pt_, nf, nt)
        assert np.isfinite(float(lp))
        assert float(lp) == pytest.approx(lj, rel=3e-5), step
        np.testing.assert_allclose(epp.numpy(), epj, rtol=1e-5, atol=2e-5)
        np.testing.assert_allclose(enp.numpy(), enj, rtol=1e-5, atol=2e-5)
        _same_params(jt, pt, f"{case} step {step}")
    assert not torch.allclose(start, pt.embedder.embedding.detach())
    if pt.cfg.energy == "hyp_cone":
        n = np.linalg.norm(pt.label_embeddings().numpy(), axis=1)
        assert (n >= R0 - 1e-6).all() and (n <= 1 - 1e-5 + 1e-6).all()


def test_optimizer_layout(setup):
    for opt in ("adam", "rsgd", "radam"):
        _, pt = make_pair(setup, energy="hyp_cone", optimizer_labels=opt)
        if opt == "adam":   # one Adam, labels as its first group
            assert pt.label_optimizer is None and pt._conformal
            assert [g["lr"] for g in pt.optimizer.param_groups] == [1e-2,
                                                                   1e-3]
        else:
            assert type(pt.label_optimizer).__name__ == {
                "rsgd": "RiemannianSGD", "radam": "RiemannianAdam"}[opt]
            assert [g["lr"] for g in pt.optimizer.param_groups] == [1e-3]
        assert pt._project == (opt != "rsgd")


@pytest.mark.parametrize("energy,K", [("hyp_cone", 0.1),
                                      ("euc_cone", 3.0)])
def test_coincident_embeddings_give_a_zero_gradient(energy, K):
    """Two images with the same features (the same picture twice) embed to
    the same point: the cone energy of that pair equals the JAX package's,
    and its gradient is finite in the port (0 from ‖x − y‖), where the JAX
    package's is NaN and poisons FeatNet's weights in one step."""
    from learning_embeddings_tpu.geometry import ENERGY_FNS as JAX_FNS
    from learning_embeddings_tpu_torch.geometry import ENERGY_FNS

    rng = np.random.RandomState(0)
    x = rng.randn(3, 4).astype(np.float32)
    x *= (0.5 if energy == "hyp_cone" else 4.0) / np.linalg.norm(
        x, axis=1, keepdims=True)
    xt, yt = (torch.tensor(x, requires_grad=True) for _ in range(2))
    e = ENERGY_FNS[energy](xt, yt, K=K)
    np.testing.assert_allclose(e.detach().numpy(), np.asarray(
        JAX_FNS[energy](jnp.asarray(x), jnp.asarray(x), K=K)), rtol=1e-6,
        atol=1e-6)
    e.sum().backward()
    assert torch.isfinite(xt.grad).all() and torch.isfinite(yt.grad).all()
    gj = jax.grad(lambda a, b: jnp.sum(JAX_FNS[energy](a, b, K=K)))(
        jnp.asarray(x), jnp.asarray(x))
    assert not np.isfinite(np.asarray(gj)).all()


@pytest.mark.parametrize("kw,match", [
    (dict(energy="hyp_cone", loss_variant="nll"), "euclidean"),
    (dict(energy="euc_cone", loss_variant="nll"), "euclidean"),
    (dict(energy="order", optimizer_labels="rsgd"), "hyperbolic"),
    (dict(energy="order", optimizer_labels="radam"), "hyperbolic")])
def test_invalid_options_raise_as_in_jax(setup, kw, match):
    for trainer, cfg in ((JaxTrainer, JaxConfig(feature_dim=32, **kw)),
                         (JointEmbeddingTrainer, JointTrainerConfig(
                             feature_dim=32, device="cpu", **kw))):
        lm = setup["jlm"] if trainer is JaxTrainer else setup["lm"]
        graph = setup["jgraph"] if trainer is JaxTrainer else setup["graph"]
        with pytest.raises(ValueError, match=match):
            trainer(lm, graph, setup["edges"], setup["feats"], cfg)


def test_mesh_and_missing_card_raise(setup):
    args = (setup["lm"], setup["graph"], setup["edges"], setup["feats"])
    with pytest.raises(NotImplementedError, match="item 21"):
        JointEmbeddingTrainer(*args, JointTrainerConfig(feature_dim=32,
                                                        device="cpu"),
                              mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            JointEmbeddingTrainer(*args, JointTrainerConfig(feature_dim=32))


def test_curriculum_stages_and_half_half_equal_jax(setup):
    curriculum = {0: (1, 2), 3: (2,), 5: ()}
    jt, pt = make_pair(setup, hide_levels=True, curriculum=curriculum,
                       half_half=True)
    for epoch in (0, 3, 4, 5, 9):
        hidden = pt.levels_for_epoch(epoch)
        assert hidden == jt.levels_for_epoch(epoch)
        edges_p = pt._stage(hidden)[0]
        np.testing.assert_array_equal(edges_p, jt._stage(hidden)[0])
        np.testing.assert_array_equal(
            epoch_order(pt, edges_p, epoch),
            jt._epoch_order(edges_p, np.random.RandomState(epoch)))
    # stage 0 hides levels 1 and 2: only level-0 label → image edges
    e0 = pt._stage((1, 2))[0]
    assert (_level_of(setup["graph"])[e0[:, 0]] == 0).all()
    assert (e0[:, 1] >= setup["graph"].n_labels).all() and len(e0) == 48
    frac = (epoch_order(pt, setup["edges"], 0)[:, 1]
            >= setup["graph"].n_labels).mean()
    assert frac == 0.5
    # the default curriculum, as the JAX config's hide_levels gives it
    _, p2 = make_pair(setup, hide_levels=True)
    assert p2.curriculum == {0: (1, 2, 3), 20: (2, 3), 50: (3,), 100: ()}


def epoch_order(pt, edges, seed):
    from learning_embeddings_tpu_torch.train.joint import epoch_edge_order

    return epoch_edge_order(pt.graph, edges, np.random.RandomState(seed),
                            pt.cfg.half_half)


@pytest.mark.parametrize("energy", ["hyp_cone", "order"])
def test_eval_matches_jax_for_the_same_parameters(setup, energy):
    jt, pt = make_pair(setup, energy=energy, feature_scale=1.0)
    rng = np.random.RandomState(5)
    val = setup["feats"][rng.permutation(len(setup["feats"]))[:20]]
    val_paths = setup["paths"][rng.permutation(len(setup["paths"]))[:20]]
    np.testing.assert_allclose(pt.image_embeddings(val).numpy(),
                               np.asarray(jt.image_embeddings(val)),
                               rtol=1e-5, atol=1e-6)
    for kw in ({}, {"img_paths_global": val_paths, "features": val}):
        got = pt.classification_metrics(**kw)
        ref = jt.classification_metrics(**kw)
        np.testing.assert_array_equal(got.pop("top1_per_level"),
                                      ref.pop("top1_per_level"))
        assert set(got) == set(ref)
        for k, v in ref.items():
            tol = dict(rel=1e-5) if "norm" in k else dict(abs=0)
            assert got[k] == pytest.approx(v, **tol), k
    em_p = pt.edge_metrics(val_paths, val)
    em_j = jt.edge_metrics(val_paths, val)
    assert float(em_p.f1) == pytest.approx(float(em_j.f1), abs=1e-6)
    assert float(em_p.threshold) == pytest.approx(float(em_j.threshold),
                                                  rel=1e-5, abs=1e-6)
    # test: each side at its own val threshold, as the runner does (an
    # energy at a shared threshold may land on either side of it)
    assert float(pt.edge_metrics(val_paths, val,
                                 threshold=float(em_p.threshold)).f1) == \
        pytest.approx(float(jt.edge_metrics(
            val_paths, val, threshold=float(em_j.threshold)).f1), abs=1e-6)
    rec_p, rec_j = pt.reconstruction(), jt.reconstruction()
    assert float(rec_p.f1) == pytest.approx(float(rec_j.f1), abs=1e-6)


def test_train_epoch_learns(setup):
    """tests/test_joint.py::test_joint_training_learns on the port: 60
    epochs of the hybrid Adam lift hit@1 and the reconstruction."""
    cfg = JointTrainerConfig(
        energy="hyp_cone", embedding_dim=4, feature_dim=32,
        lr_labels=0.01, lr_images=0.01, batch_size=12, neg_to_pos_ratio=4,
        alpha=0.01, optimizer_labels="adam", pick_per_level=True, seed=0,
        device="cpu")
    tr = JointEmbeddingTrainer(setup["lm"], setup["graph"], setup["edges"],
                               setup["feats"], cfg)
    rng = np.random.RandomState(0)
    m0 = tr.classification_metrics()
    for ep in range(60):
        st = tr.train_epoch(ep, rng)
    assert all(np.isfinite(v) for v in st.values())
    m1 = tr.classification_metrics()
    assert m1["hit@1"] > max(2 * m0["hit@1"], 0.5)
    assert m1["micro_f1"] > m0["micro_f1"]
    assert float(tr.reconstruction().f1) > 0.6
    assert m1["median_label_norm"] < 1.0 and m1["median_img_norm"] < 1.0


def test_train_epoch_runs_the_curriculum_stage(setup):
    """An epoch of a stage that hides levels 1 and 2 trains on that
    stage's 48 edges (4 batches of 12) with its sampler."""
    cfg = JointTrainerConfig(energy="order", embedding_dim=4,
                             feature_dim=32, batch_size=12,
                             neg_to_pos_ratio=3, hide_levels=True,
                             curriculum={0: (1, 2), 1: ()}, seed=0,
                             device="cpu")
    tr = JointEmbeddingTrainer(setup["lm"], setup["graph"], setup["edges"],
                               setup["feats"], cfg)
    seen = []
    step = tr.train_step
    tr.train_step = lambda *a: (seen.append([x.clone() for x in a]),
                                step(*a))[1]
    tr.train_epoch(0, np.random.RandomState(0))
    assert len(seen) == 4 and sorted(tr._stage_cache) == [(1, 2)]
    lvl = _level_of(setup["graph"])
    # passes cycle over the visible levels 0 and 3 (images): 0, 3, 0; the
    # label passes draw level-0 labels only (on the image pass an image
    # anchor draws any non-ancestor label, as the JAX and numpy samplers
    # do)
    for pf, pt_, nf, nt in seen:
        assert (lvl[pf.numpy()] == 0).all()
        nf2, nt2 = nf.numpy().reshape(12, 6), nt.numpy().reshape(12, 6)
        assert (lvl[nt2[:, [0, 2]]] == 0).all()
        assert (lvl[nf2[:, [3, 5]]] == 0).all()
        assert (nt2[:, 1] >= setup["graph"].n_labels).all()
    tr.train_epoch(1, np.random.RandomState(1))
    assert len(seen) == 4 + len(setup["edges"]) // 12
    assert sorted(tr._stage_cache) == [(), (1, 2)]


@pytest.mark.parametrize("opt", ["adam", "rsgd"])
def test_checkpoint_round_trip(setup, tmp_path, opt):
    cfg = JointTrainerConfig(energy="hyp_cone", optimizer_labels=opt,
                             embedding_dim=4, feature_dim=32, batch_size=12,
                             seed=0, device="cpu")
    args = (setup["lm"], setup["graph"], setup["edges"], setup["feats"])
    a = JointEmbeddingTrainer(*args, cfg)
    a.train_epoch(0, np.random.RandomState(0))
    a.optimal_threshold = 0.0        # a legitimate cone threshold
    ck = Checkpointer(_Dir(str(tmp_path)))
    ck.save("w", a.checkpoint_payload())
    b = JointEmbeddingTrainer(*args, cfg)
    b.restore_payload(ck.load("w", b.checkpoint_payload()))
    assert b.optimal_threshold == 0.0
    for x, y in ((a.embedder, b.embedder), (a.featnet, b.featnet)):
        for (k, v), (_, w) in zip(x.state_dict().items(),
                                  y.state_dict().items()):
            assert torch.equal(v, w), k
    # the same step from the restored optimizer state
    batch = setup["edges"][:12]
    nf, nt = a._stage(())[1](torch.Generator().manual_seed(0),
                             _ids(batch[:, 0]), _ids(batch[:, 1]))
    la = a.train_step(batch[:, 0], batch[:, 1], nf, nt)[0]
    lb = b.train_step(batch[:, 0], batch[:, 1], nf, nt)[0]
    assert torch.equal(la, lb)
    assert torch.equal(a.embedder.embedding, b.embedder.embedding)
    # NaN stands for "no calibrated threshold"
    b.optimal_threshold = None
    assert np.isnan(b.checkpoint_payload()["optimal_threshold"])
    a.restore_payload(b.checkpoint_payload())
    assert a.optimal_threshold is None


class _Dir:
    def __init__(self, root):
        self.weights = root


def test_load_embedding_table_matches_jax(setup):
    jt, pt = make_pair(setup)
    table = np.random.RandomState(3).randn(setup["graph"].n_labels, 4) * 5
    pt.load_embedding_table(table)
    jt.load_embedding_table(table)
    np.testing.assert_allclose(
        pt.embedder.embedding.detach().numpy(),
        np.asarray(jt.params["labels"]["params"]["embedding"]), rtol=1e-6,
        atol=1e-7)
    with pytest.raises(ValueError, match="matched 0"):
        pt.load_embedding_table(table[:, :3])


# ----------------------------------------------------------------------
# the runner
# ----------------------------------------------------------------------
def _runner_kw(setup, root, name, **kw):
    feats = setup["feats"]
    return dict(experiment_dir=str(root), experiment_name=name,
                n_epochs=3, eval_interval=1,
                eval_features={"val": feats[::2], "test": feats[1::2]},
                eval_paths={"val": setup["paths"][::2],
                            "test": setup["paths"][1::2]}, **kw)


def _metrics(exp):
    import json

    with open(os.path.join(exp.logs, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


RUNNER_CFG = dict(energy="hyp_cone", embedding_dim=4, feature_dim=32,
                  batch_size=12, neg_to_pos_ratio=3, alpha=0.05, seed=0)


def test_runner_logs_the_jax_runners_tags(setup, tmp_path):
    res = run_joint_embedding(
        setup["lm"], setup["graph"], setup["edges"], setup["feats"],
        JointTrainerConfig(device="cpu", **RUNNER_CFG),
        **_runner_kw(setup, tmp_path / "p", "j"))
    jres = jax_run_joint_embedding(
        setup["jlm"], setup["jgraph"], setup["edges"], setup["feats"],
        JaxConfig(donate=False, **RUNNER_CFG),
        **_runner_kw(setup, tmp_path / "j", "j"))
    got, want = _metrics(res["experiment"]), _metrics(jres["experiment"])
    assert sorted((r["tag"], r["step"]) for r in got) == \
        sorted((r["tag"], r["step"]) for r in want)
    assert sorted(os.listdir(res["experiment"].weights)) == \
        sorted(os.listdir(jres["experiment"].weights))
    assert set(res) == set(jres)
    assert set(res["test_metrics"]) == set(jres["test_metrics"])
    assert "edge_f1" in res["test_metrics"]
    assert all(np.isfinite(v) for v in res["test_metrics"].values())


def test_runner_resume_keeps_best_tracking(setup, tmp_path):
    cfg = JointTrainerConfig(device="cpu", **RUNNER_CFG)
    args = (setup["lm"], setup["graph"], setup["edges"], setup["feats"],
            cfg)
    kw = _runner_kw(setup, tmp_path, "r")
    res1 = run_joint_embedding(*args, **{**kw, "n_epochs": 2})
    assert res1["best_epoch"] >= 0
    assert res1["trainer"].optimal_threshold is not None
    # resume past completion: no epoch runs, the original best reported
    res2 = run_joint_embedding(*args, **{**kw, "n_epochs": 2,
                                         "resume": True})
    assert res2["best_val_micro_f1"] == pytest.approx(
        res1["best_val_micro_f1"])
    assert res2["best_epoch"] == res1["best_epoch"]
    res3 = run_joint_embedding(*args, **{**kw, "n_epochs": 4,
                                         "resume": True})
    assert res3["best_val_micro_f1"] >= res1["best_val_micro_f1"]
    exp = res3["experiment"]
    assert [r["step"] for r in _metrics(exp)
            if r["tag"] == "train/loss"] == [0, 1, 2, 3]
    best = Checkpointer(exp).load("best_model", {"best_f1": -1.0,
                                                 "best_epoch": -1.0})
    assert best["best_f1"] == pytest.approx(res3["best_val_micro_f1"])


def test_runner_takes_its_warm_start_and_scores_train_images(setup,
                                                            tmp_path):
    """init_embeddings and init_threshold reach the trainer; without
    held-out features the train images are scored, with no edge pass and
    no threshold swept on test."""
    table = np.random.RandomState(1).uniform(
        -0.3, 0.3, (setup["graph"].n_labels, 4)).astype(np.float32)
    res = run_joint_embedding(
        setup["lm"], setup["graph"], setup["edges"], setup["feats"],
        JointTrainerConfig(device="cpu", **RUNNER_CFG),
        experiment_dir=str(tmp_path), experiment_name="w", n_epochs=0,
        init_embeddings=table, init_threshold=0.25)
    tr = res["trainer"]
    assert tr.optimal_threshold == 0.25
    np.testing.assert_allclose(tr.embedder.embedding.detach().numpy(),
                               table)
    assert res["best_epoch"] == -1 and "edge_f1" not in res["test_metrics"]
    with pytest.raises(NotImplementedError, match="item 21"):
        run_joint_embedding(
            setup["lm"], setup["graph"], setup["edges"], setup["feats"],
            JointTrainerConfig(device="cpu", **RUNNER_CFG),
            experiment_dir=str(tmp_path), experiment_name="m", n_epochs=0,
            mesh=object())


# ----------------------------------------------------------------------
# the fc7 CLIs, on features that the port's image_emb wrote
# ----------------------------------------------------------------------
@pytest.fixture
def fc7_features(png_split, tmp_path):  # noqa: F811
    data, images = png_split
    out = str(tmp_path / "feats")
    t_emb.main(["--data_dir", data, "--image_dir", images, "--output_dir",
                out, "--model", "resnet18", "--image_size", "16",
                "--batch_size", "4", "--n_workers", "2", "--device", "cpu"])
    return data, images, out


def _fc7_argv(data, images, feats, exp, name, *extra):
    return ["--data_dir", data, "--image_dir", images, "--features_dir",
            feats, "--experiment_dir", exp, "--experiment_name", name,
            "--set_mode", "train", *extra]


def test_oe_h_fc7_trains_resumes_like_the_jax_cli(fc7_features, tmp_path):
    data, images, feats = fc7_features
    exp = str(tmp_path / "exp")
    res = t_oe_h.main(_fc7_argv(data, images, feats, exp, "h", "--n_epochs",
                                "2", "--device", "cpu"))
    tr = res["trainer"]
    assert tr.cfg.energy == "hyp_cone" and tr.cfg.pick_per_level is False
    assert tr.featnet.fc1.in_features == 512      # ResNet-18's features
    root = os.path.join(exp, "h")
    assert sorted(os.listdir(os.path.join(root, "weights"))) == [
        "0", "1", "best_model"]
    assert np.isfinite(res["reconstruction_f1"])
    assert "edge_f1" in res["test_metrics"]
    assert all(np.isfinite(v) for v in res["test_metrics"].values())
    manifest = read_manifest(os.path.join(root, "config_params.txt"))
    assert manifest["model"] == "alexnet" and manifest["use_CNN"] == "False"
    # --resume to 3 runs epoch 2 only
    res3 = t_oe_h.main(_fc7_argv(data, images, feats, exp, "h", "--n_epochs",
                                 "3", "--resume", "--device", "cpu"))
    assert [r["step"] for r in _metrics(res3["experiment"])
            if r["tag"] == "train/loss"] == [0, 1, 2]
    assert res3["best_val_micro_f1"] >= res["best_val_micro_f1"]

    # the JAX CLI on the same features: the same tags and manifest keys
    jres = j_oe_h.main(_fc7_argv(data, images, feats, exp, "j",
                                 "--n_epochs", "2"))
    jm = read_manifest(os.path.join(exp, "j", "config_params.txt"))
    assert set(manifest) == set(jm) | {"device"}
    assert {k: v for k, v in manifest.items()
            if k not in ("device", "experiment_name")} == \
        {k: v for k, v in jm.items() if k != "experiment_name"}
    assert sorted({r["tag"] for r in _metrics(res["experiment"])}) == \
        sorted({r["tag"] for r in _metrics(jres["experiment"])})


def test_oe_fc7_order_energy(fc7_features, tmp_path):
    data, images, feats = fc7_features
    res = t_oe.main(_fc7_argv(data, images, feats, str(tmp_path), "o",
                              "--n_epochs", "1", "--pick_per_level",
                              "--device", "cpu"))
    assert res["trainer"].cfg.energy == "order"
    assert res["trainer"].cfg.pick_per_level
    assert np.isfinite(res["reconstruction_f1"])
    assert "edge_f1" in res["test_metrics"]


def test_fc7_cli_errors(fc7_features, tmp_path):
    data, images, feats = fc7_features
    with pytest.raises(FileNotFoundError, match="image_emb"):
        t_oe_h.main(_fc7_argv(data, images, str(tmp_path / "none"),
                              str(tmp_path), "x", "--n_epochs", "1",
                              "--device", "cpu"))
    with pytest.raises(SystemExit, match="requires --use_CNN"):
        t_oe_h.main(_fc7_argv(data, images, feats, str(tmp_path), "x",
                              "--n_epochs", "1", "--load_tower_from",
                              str(tmp_path), "--device", "cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            t_oe_h.main(_fc7_argv(data, images, feats, str(tmp_path), "x",
                                  "--n_epochs", "1"))


def test_load_features_aligns_rows_with_the_dataset(fc7_features, capsys):
    from learning_embeddings_tpu.cli._joint_main import (
        load_features as jax_load_features)
    from learning_embeddings_tpu_torch.cli.common import load_ethec_data

    data, _, feats = fc7_features
    _, datasets, _ = load_ethec_data(data)
    for split, ds in datasets.items():
        got = load_features(feats, split, ds)
        np.testing.assert_array_equal(got, jax_load_features(feats, split,
                                                             ds))
        with np.load(os.path.join(feats, f"{split}.npz")) as z:
            by_path = dict(zip(z["paths"], z["features"]))
        assert got.dtype == np.float32 and got.shape == (len(ds), 512)
        for p, row in zip(ds.image_paths, got):
            np.testing.assert_array_equal(row, by_path[p])


def test_freeze_weights_prints_the_note(fc7_features, tmp_path, capsys):
    data, images, feats = fc7_features
    t_oe_h.main(_fc7_argv(data, images, feats, str(tmp_path), "f",
                          "--n_epochs", "1", "--freeze_weights", "--device",
                          "cpu"))
    assert "fc7 features are already frozen" in capsys.readouterr().out
