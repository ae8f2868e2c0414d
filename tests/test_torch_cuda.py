"""The port's hand-written kernels against their plain versions on an
NVIDIA card. Every test here is marked `cuda` and skips without a card (a
CUDA or Triton kernel has no CPU mode). The file imports no JAX, so that
it runs on a machine with torch alone:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from learning_embeddings_tpu_torch.ops import bn, bn_triton
from learning_embeddings_tpu_torch.ops import pairwise_order as k3

pytestmark = pytest.mark.cuda

#: (M, N, D): both routes' boundaries (D = 1, 2, 10, 16 = EXACT_D_MAX, then
#: 17 and 131 on the generic route), N ≡ 0, 1, 2, 3 (mod 4), M off the
#: 16-row tiles, the eval's shapes at 344 and 723 labels, and an empty one
K3_SHAPES = [(1, 1, 1), (37, 129, 10), (130, 7, 3), (5, 300, 131),
             (344, 5286, 10), (344, 344, 10), (0, 5, 3),
             (17, 128, 2), (33, 131, 16), (19, 130, 17), (7, 255, 5),
             (45, 4099, 12), (344, 5049, 10), (723, 5286, 10),
             (723, 723, 10)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape", K3_SHAPES, ids=str)
def test_pairwise_order_kernel_matches_plain(gen, shape):
    m, n, d = shape
    ui = torch.randint(-3, 4, (m, d), device="cuda", generator=gen).float()
    vi = torch.randint(-3, 4, (n, d), device="cuda", generator=gen).float()
    before = (k3.LAUNCHES, k3.EXACT_D_LAUNCHES, k3.GENERIC_LAUNCHES)
    got = k3.pairwise_order(ui, vi)
    torch.cuda.synchronize()
    exact = int(bool(m and n) and k3.route_for(d) == "exact_d")
    generic = int(bool(m and n) and k3.route_for(d) == "generic")
    assert (k3.LAUNCHES, k3.EXACT_D_LAUNCHES, k3.GENERIC_LAUNCHES) == (
        before[0] + exact + generic, before[1] + exact, before[2] + generic)
    # integer-valued inputs: every partial sum is exact in f32
    assert torch.equal(got, k3.pairwise_order_plain(ui, vi))
    u = torch.randn((m, d), device="cuda", generator=gen)
    v = torch.randn((n, d), device="cuda", generator=gen)
    got = k3.pairwise_order(u, v)
    ref = k3.pairwise_order_plain(u, v)   # also Σ_d of the (≥ 0) terms
    # the same f32 terms summed in another order
    assert bool(((got - ref).abs() <= 1e-5 * ref + 1e-6).all())


@pytest.mark.parametrize("shape", [(37, 129, 10), (344, 5049, 10),
                                   (17, 128, 2)], ids=str)
def test_generic_route_matches_plain_at_small_d(gen, shape):
    """The generic kernel, which pairwise_order takes only past
    EXACT_D_MAX, is right at the exact_d route's D too."""
    m, n, d = shape
    ui = torch.randint(-3, 4, (m, d), device="cuda", generator=gen).float()
    vi = torch.randint(-3, 4, (n, d), device="cuda", generator=gen).float()
    before = (k3.EXACT_D_LAUNCHES, k3.GENERIC_LAUNCHES)
    got = k3.pairwise_order_generic(ui, vi)
    torch.cuda.synchronize()
    assert (k3.EXACT_D_LAUNCHES, k3.GENERIC_LAUNCHES) == (before[0],
                                                          before[1] + 1)
    assert torch.equal(got, k3.pairwise_order_plain(ui, vi))


@pytest.mark.parametrize("R,C", [(12345, 100), (25088, 2048), (401408, 64)])
def test_bn_kernels_match_plain(gen, R, C):
    ints = [torch.randint(-1, 2, (R, C), device="cuda", generator=gen)
            .to(torch.bfloat16) for _ in range(2)]
    for got, want in ((bn_triton.bn_stats(ints[0]),
                       bn._stats_plain(ints[0])),
                      (bn_triton.bn_corr(*ints), bn._corr_plain(*ints))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)   # integer sums are exact in f32


def test_hyperbolic_joint_step_on_the_card(gen):
    """One f32 ResNet-18 joint step with the hyperbolic-cone energy and the
    hybrid Adam on the labels, on the card against the CPU from the same
    seed: the loss (rel 1e-4) and the label table (abs 1e-5), one launch
    of each BN kernel per BN layer (ResNet-18 has 20) on the card and none
    on the CPU, and the label embeddings in the annulus."""
    import numpy as np

    from learning_embeddings_tpu_torch.geometry import inner_radius
    from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
    from learning_embeddings_tpu_torch.losses.joint_sampling import (
        build_joint_graph)
    from learning_embeddings_tpu_torch.train.joint_cnn import (
        JointCNNConfig, JointCNNTrainer)

    lm = toy_labelmap(2, 3)
    rng = np.random.RandomState(0)
    graph, edges = build_joint_graph(
        lm, lm.leaf_paths()[rng.randint(0, lm.levels[-1], 24)])
    bank = rng.randint(0, 256, (24, 32, 32, 3)).astype(np.uint8)
    batch = edges[edges[:, 1] >= graph.n_labels][::3][:8]
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", "cuda"):
            tr = JointCNNTrainer(lm, graph, edges, lambda r: bank[r % 24],
                                 JointCNNConfig(
                                     energy="hyp_cone", backbone="resnet18",
                                     embedding_dim=4, image_size=32,
                                     batch_size=8, neg_to_pos_ratio=4,
                                     alpha=0.5, lr_images=1e-5,
                                     tower_dtype="float32", device=dev))
            before = (bn_triton.STATS_LAUNCHES, bn_triton.CORR_LAUNCHES)
            loss, _, _ = tr.train_batch(batch[:, 0], batch[:, 1])
            torch.cuda.synchronize()
            out[dev] = (loss, tr.embedder.embedding.detach().cpu(),
                        tr.label_embeddings().cpu(),
                        (bn_triton.STATS_LAUNCHES - before[0],
                         bn_triton.CORR_LAUNCHES - before[1]))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    (lc, tc, ec, nc), (lp, tp, _, np_) = out["cuda"], out["cpu"]
    assert nc == (20, 20) and np_ == (0, 0)
    assert abs(lc - lp) <= 1e-4 * abs(lp)
    assert (tc - tp).abs().max().item() <= 1e-5
    norms = ec.norm(dim=1)
    assert bool((norms >= inner_radius(0.1) - 1e-6).all())
    assert bool((norms <= 1 - 1e-5 + 1e-6).all())


def test_label_runner_resumes_on_the_card(gen, tmp_path):
    """run_label_embedding with the order energy on the card, 2 epochs
    then --resume to 3: every reconstruction (check_reconstr_every 1, and
    the final one) launches the exact_d kernel once, the checkpoints load
    back to the card, and the resumed run starts at epoch 2."""
    import json
    import os

    from learning_embeddings_tpu_torch.hierarchy import (
        label_graph_from_paths, split_edges, toy_labelmap)
    from learning_embeddings_tpu_torch.train.embedding import (
        EmbeddingTrainerConfig)
    from learning_embeddings_tpu_torch.train.runner import (
        run_label_embedding)

    lm = toy_labelmap(3, 3)
    splits = split_edges(label_graph_from_paths(lm.leaf_paths(), lm),
                         proportion_of_nb_edges_in_train=0.5, val_frac=0.15,
                         test_frac=0.15)
    cfg = EmbeddingTrainerConfig(energy="order", optimizer="adam",
                                 embedding_dim=10, batch_size=8, lr=1e-2)
    kw = dict(experiment_dir=str(tmp_path), experiment_name="r",
              check_reconstr_every=1)
    before = (k3.LAUNCHES, k3.EXACT_D_LAUNCHES)
    run_label_embedding(lm, splits, cfg, n_epochs=2, **kw)
    res = run_label_embedding(lm, splits, cfg, n_epochs=3, resume=True, **kw)
    torch.cuda.synchronize()
    # 2 + 1 per-epoch reconstructions and one final one per run
    assert (k3.LAUNCHES - before[0], k3.EXACT_D_LAUNCHES - before[1]) == \
        (5, 5)
    assert res["trainer"].model.embedding.device.type == "cuda"
    assert np.isfinite(res["reconstruction_f1"])
    with open(os.path.join(str(tmp_path), "r", "logs", "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f
                 if '"train/loss"' in line]
    assert steps == [0, 1, 2]


def test_label_only_epoch_on_the_card(gen):
    """One epoch of the label-only trainer on the card for each energy the
    smoke run trains; the order run's reconstruction launches the exact_d
    kernel once and its energies match the plain version."""
    from learning_embeddings_tpu_torch.hierarchy import (
        label_graph_from_paths, split_edges, toy_labelmap)
    from learning_embeddings_tpu_torch.train.embedding import (
        EmbeddingTrainer, EmbeddingTrainerConfig)

    lm = toy_labelmap(3, 3)
    splits = split_edges(label_graph_from_paths(lm.leaf_paths(), lm),
                         proportion_of_nb_edges_in_train=0.5, val_frac=0.15,
                         test_frac=0.15)
    for energy, opt in (("hyp_cone", "adam"), ("hyp_cone", "rsgd"),
                        ("order", "adam")):
        tr = EmbeddingTrainer(lm, splits, EmbeddingTrainerConfig(
            energy=energy, optimizer=opt, embedding_dim=10, batch_size=8,
            alpha=0.05, lr=1e-3))
        stats = tr.train_epoch()
        assert all(map(np.isfinite, stats.values())), (energy, opt, stats)
        tr.evaluate("val")
        tr.evaluate("test")
        before = (k3.LAUNCHES, k3.EXACT_D_LAUNCHES)
        rec = tr.reconstruction()
        torch.cuda.synchronize()
        launched = (k3.LAUNCHES - before[0], k3.EXACT_D_LAUNCHES - before[1])
        assert launched == ((1, 1) if energy == "order" else (0, 0))
        assert np.isfinite(float(rec.f1))
        if energy == "order":
            emb = tr.all_embeddings()[:lm.n_classes]
            got, ref = k3.pairwise_order(emb, emb), \
                k3.pairwise_order_plain(emb, emb)
            assert bool(((got - ref).abs() <= 1e-5 * ref + 1e-6).all())


def test_classifier_runner_on_the_card(gen, tmp_path):
    """run_classifier on the card (ResNet-18 at 32², an in-memory split,
    grad_accum 2, then --resume): 20 + 20 BN launches in every train step,
    none in the eval steps, and the checkpoints load back to the card."""
    import json
    import os

    from learning_embeddings_tpu_torch.data.records import (
        multihot_from_level_labels)
    from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig)
    from learning_embeddings_tpu_torch.train.runner import run_classifier

    lm = toy_labelmap(2, 3)
    rng = np.random.RandomState(0)

    class InMemory:
        def __init__(self, n):
            self.images = rng.randint(0, 256, (n, 40, 40, 3)).astype(
                np.uint8)
            self.level_labels = lm.leaf_paths()[rng.randint(
                0, lm.levels[-1], n)].astype(np.int32)
            self.leaf_labels = self.level_labels[:, -1].copy()

        def __len__(self):
            return len(self.images)

        def multihot(self, labelmap):
            return multihot_from_level_labels(self.level_labels, labelmap)

    datasets = {"train": InMemory(32), "val": InMemory(12),
                "test": InMemory(12)}
    cfg = ClassifierConfig(backbone="resnet18", image_size=32, batch_size=8,
                           lr=1e-4, grad_accum=2)
    kw = dict(experiment_dir=str(tmp_path), experiment_name="c",
              n_workers=2)
    before = (bn_triton.STATS_LAUNCHES, bn_triton.CORR_LAUNCHES)
    run_classifier(lm, datasets, "", cfg, n_epochs=2, **kw)
    torch.cuda.synchronize()
    assert (bn_triton.STATS_LAUNCHES - before[0],
            bn_triton.CORR_LAUNCHES - before[1]) == (2 * 4 * 20, 2 * 4 * 20)
    res = run_classifier(lm, datasets, "", cfg, n_epochs=3, resume=True,
                         **kw)
    assert all(np.isfinite(v) for v in res["test_metrics"].values())
    with open(os.path.join(str(tmp_path), "c", "logs", "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f
                 if '"train/loss"' in line]
    assert steps == [0, 1, 2]


def test_fc7_joint_epoch_and_order_eval_on_the_card(gen):
    """The fc7 joint trainer on the card: a few steps on given negatives
    equal the CPU path's (loss rel 1e-5, label table and FeatNet abs
    1e-5), one epoch per energy with device-drawn negatives, and the
    order energy's eval (two rankings, one reconstruction) launching the
    exact_d kernel 3 times, equal to the plain version; the hyperbolic
    eval launches none."""
    from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
    from learning_embeddings_tpu_torch.losses.joint_sampling import (
        build_joint_graph)
    from learning_embeddings_tpu_torch.train.joint import (
        JointEmbeddingTrainer, JointTrainerConfig)

    lm = toy_labelmap(3, 3)
    rng = np.random.RandomState(0)
    leaves = rng.randint(0, lm.levels[-1], 200)
    graph, edges = build_joint_graph(lm, lm.leaf_paths()[leaves])
    feats = (0.05 * rng.randn(200, 64)).astype(np.float32)
    val = (0.05 * rng.randn(50, 64)).astype(np.float32)
    val_paths = (lm.leaf_paths()[rng.randint(0, lm.levels[-1], 50)]
                 + np.asarray(lm.level_start)[None, :])
    for energy in ("hyp_cone", "order"):
        cfgs = {dev: JointTrainerConfig(energy=energy, feature_dim=64,
                                        batch_size=10, seed=0, device=dev)
                for dev in ("cpu", "cuda")}
        tr = {dev: JointEmbeddingTrainer(lm, graph, edges, feats, c)
              for dev, c in cfgs.items()}
        sampler = tr["cpu"]._stage(())[1]
        g = torch.Generator().manual_seed(0)
        for b in range(3):
            e = torch.as_tensor(edges[10 * b:10 * (b + 1)]).long()
            nf, nt = sampler(g, e[:, 0], e[:, 1])
            lp = tr["cpu"].train_step(e[:, 0], e[:, 1], nf, nt)[0]
            lc = tr["cuda"].train_step(e[:, 0], e[:, 1], nf, nt)[0]
            assert abs(float(lc) - float(lp)) <= 1e-5 * abs(float(lp))
        for name in ("embedder", "featnet"):
            for (k, v), w in zip(
                    getattr(tr["cpu"], name).state_dict().items(),
                    getattr(tr["cuda"], name).state_dict().values()):
                assert (w.cpu() - v).abs().max().item() <= 1e-5, (name, k)
        t = tr["cuda"]
        stats = t.train_epoch(0, np.random.RandomState(0))
        assert all(map(np.isfinite, stats.values())), (energy, stats)
        before = (k3.LAUNCHES, k3.EXACT_D_LAUNCHES)
        t.classification_metrics()
        t.classification_metrics(val_paths, val)
        t.reconstruction()
        torch.cuda.synchronize()
        launched = (k3.LAUNCHES - before[0], k3.EXACT_D_LAUNCHES - before[1])
        assert launched == ((3, 3) if energy == "order" else (0, 0))
        if energy == "order":
            lab, img = t.label_embeddings(), t.image_embeddings(val)
            got, ref = k3.pairwise_order(lab, img), \
                k3.pairwise_order_plain(lab, img)
            assert bool(((got - ref).abs() <= 1e-5 * ref + 1e-6).all())
