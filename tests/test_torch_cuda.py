"""The port's hand-written kernels against their plain versions on an
NVIDIA card. Every test here is marked `cuda` and skips without a card (a
CUDA or Triton kernel has no CPU mode). The file imports no JAX, so that
it runs on a machine with torch alone:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import time

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


#: (R, C) of the 20 BatchNorm layers of ResNet-18 at 224², batch 8 (the
#: CIFAR / FashionMNIST CLIs' defaults): 1, 4, 5, 5 and 5 layers
RESNET18_224_B8 = [(100352, 64), (25088, 64), (6272, 128), (1568, 256),
                   (392, 512)]


@pytest.mark.parametrize("R,C", [(12345, 100), (25088, 2048), (401408, 64)]
                         + RESNET18_224_B8)
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


def test_fashion_mnist_cli_on_the_card(gen, tmp_path, capsys):
    """cli/fashion_mnist.py on the card (synthetic stand-in, ResNet-18 at
    32² on the 1-channel stem): 20 + 20 BN launches in each train step,
    none in the eval steps, and no channels_last copy."""
    from learning_embeddings_tpu_torch.cli import fashion_mnist

    bn.CHANNELS_LAST_COPIES = 0
    before = (bn_triton.STATS_LAUNCHES, bn_triton.CORR_LAUNCHES)
    res = fashion_mnist.main([
        "--experiment_dir", str(tmp_path), "--experiment_name", "f",
        "--n_epochs", "1", "--loss", "multi_level", "--set_mode", "train",
        "--debug", "--image_size", "32", "--batch_size", "32",
        "--data_root", str(tmp_path / "none")])
    torch.cuda.synchronize()
    assert "synthetic stand-in" in capsys.readouterr().out
    steps = res["train_steps"]
    assert steps > 10
    assert (bn_triton.STATS_LAUNCHES - before[0],
            bn_triton.CORR_LAUNCHES - before[1]) == (20 * steps, 20 * steps)
    assert bn.CHANNELS_LAST_COPIES == 0
    assert all(np.isfinite(v) for v in res["test_metrics"].values())


def test_inference_on_the_card_matches_the_cpu(gen):
    """The occlusion maps and LIME's per-level softmax of one float32
    classifier (ResNet-18 at 64², random BatchNorm running statistics),
    on the card and on the CPU from the same weights, TF32 off: within
    rtol 1e-4 / atol 1e-5 (two summation orders); no BN kernel runs."""
    from learning_embeddings_tpu_torch.cli import inference
    from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig, ClassifierTrainer)

    lm = toy_labelmap(2, 3)
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (1, 64, 64, 3)).astype(np.uint8)
    ll = lm.leaf_paths()[3]
    out, state = {}, None
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            tr = ClassifierTrainer(lm, ClassifierConfig(
                backbone="resnet18", image_size=64, dtype=torch.float32,
                device=dev))
            if state is None:
                g = torch.Generator().manual_seed(1)
                state = {k: (v + 0.1 * torch.randn(v.shape, generator=g)
                             if k.endswith("running_mean") else
                             v * (0.5 + torch.rand(v.shape, generator=g))
                             if k.endswith("running_var") else v.clone())
                         for k, v in tr.model.state_dict().items()}
            tr.model.load_state_dict(state)
            slices = inference.level_slices(tr)
            before = (bn_triton.STATS_LAUNCHES, bn_triton.CORR_LAUNCHES)
            maps = inference.occlusion_maps(tr, img, ll, slices)
            probs = inference.lime_predict(tr, slices)(
                np.repeat(img.astype(np.float32) / 255.0, 3, axis=0))
            assert (bn_triton.STATS_LAUNCHES,
                    bn_triton.CORR_LAUNCHES) == before
            out[dev] = (maps, probs)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert out["cuda"][0].shape == (lm.n_levels, 4, 4)   # patch 16, stride 16
    for got, want in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("R,C", [(12345, 100), (401408, 64), (25088, 2048)])
def test_bn_stats_bf16_rounding_variant_matches_plain(gen, R, C):
    """K1's rounding variant (each x² rounded to bf16 before the sum, the
    bf16 BatchNorm statistics): equal to its plain version on values whose
    squares and sums are exact, within 1e-5·Σ|terms| on normal ones, and
    counted as a K1 launch."""
    before = (bn_triton.STATS_LAUNCHES, bn_triton.STATS_ROUNDED_LAUNCHES)
    ints = torch.randint(-3, 4, (R, C), device="cuda", generator=gen) \
        .to(torch.bfloat16)
    for g, w in zip(bn_triton.bn_stats(ints, True),
                    bn._stats_plain(ints, True)):
        assert torch.equal(g, w)
    x = torch.randn((R, C), device="cuda", generator=gen).to(torch.bfloat16)
    got, want = bn_triton.bn_stats(x, True), bn._stats_plain(x, True)
    mag = bn._stats_plain(x.float().abs(), True)
    for g, w, m in zip(got, want, mag):
        assert bool(((g - w).abs() <= 1e-5 * m + 1e-6).all())
    # the rounding shows: Σ round(x²) is not Σ x²
    assert not torch.equal(got[1], bn._stats_plain(x)[1])
    torch.cuda.synchronize()
    assert (bn_triton.STATS_LAUNCHES, bn_triton.STATS_ROUNDED_LAUNCHES) == (
        before[0] + 2, before[1] + 2)


def test_ghost_batch_norm_reads_a_row_prefix_on_the_card(gen):
    """GhostBatchNorm on the card: K1 on the first stats_rows images (with
    the rounding variant for bf16 statistics), K2 on all rows, and the
    same y, statistics and gradients as the CPU path."""
    from learning_embeddings_tpu_torch.ops.bn import GhostBatchNorm

    x = torch.randn((16, 64, 28, 28), generator=torch.Generator()
                    .manual_seed(0)).to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)) \
        .to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    for stats_dtype in (torch.float32, torch.bfloat16):
        out = {}
        for dev in ("cpu", "cuda"):
            m = GhostBatchNorm(64, torch.bfloat16, 8, stats_dtype).to(dev)
            tx = x.to(dev, copy=True).requires_grad_(True)
            seen = []
            launch = bn_triton._launch

            def record(kernel, name, *ts, **kw):
                seen.append((name, tuple(ts[0].shape), kw))
                return launch(kernel, name, *ts, **kw)
            bn_triton._launch = record
            try:
                y = m.train()(tx)
                y.backward(dy.to(dev))
            finally:
                bn_triton._launch = launch
            out[dev] = [t.detach().float().cpu() for t in
                        (y, tx.grad, m.weight.grad, m.bias.grad,
                         m.running_mean, m.running_var)]
            if dev == "cuda":
                assert seen == [
                    ("bn_stats", (8 * 28 * 28, 64),
                     {"ROUND_SQ": stats_dtype == torch.bfloat16}),
                    ("bn_corr", (16 * 28 * 28, 64), {})]
        for a, b in zip(out["cuda"], out["cpu"]):
            assert torch.allclose(a, b, rtol=1e-2,
                                  atol=1e-2 * b.abs().max().item())


def _resnet50_step_counts(**cfg_kw):
    from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig, ClassifierTrainer)

    lm = toy_labelmap(2, 3)
    tr = ClassifierTrainer(lm, ClassifierConfig(
        backbone="resnet50", image_size=64, batch_size=4, device="cuda",
        **cfg_kw))
    rng = np.random.RandomState(0)
    ll = lm.leaf_paths()[rng.randint(0, lm.levels[-1], 4)]
    b = tr.put_batch(rng.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8),
                     ll, np.zeros((4, lm.n_classes), np.float32))
    before = (bn_triton.STATS_LAUNCHES, bn_triton.CORR_LAUNCHES)
    _, loss = tr.train_step(tr.state, *b)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    return (bn_triton.STATS_LAUNCHES - before[0],
            bn_triton.CORR_LAUNCHES - before[1])


def test_remat_step_launch_counts(gen):
    """A ResNet-50 step with remat: K1 53 + 52 times (the 52 block
    BatchNorms recompute their forward in the backward pass; the stem's
    does not), K2 53 times."""
    assert _resnet50_step_counts(remat=True) == (105, 53)
    assert _resnet50_step_counts() == (53, 53)


def test_flax_route_launches_no_bn_kernel(gen):
    assert _resnet50_step_counts(bn_impl="flax") == (0, 0)
    assert _resnet50_step_counts(bn_impl="flax", bn_stats_rows=2) == (53, 53)


def _cls_batch(lm, B, size, seed):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (B, size, size, 3)).astype(np.uint8)
    ll = lm.leaf_paths()[rng.randint(0, lm.levels[-1], B)].astype(np.int32)
    mh = np.zeros((B, lm.n_classes), np.float32)
    mh[np.arange(B)[:, None], ll + np.asarray(lm.level_start)] = 1.0
    return imgs, ll, mh


def test_two_gloo_ranks_on_the_card_match_one_process(gen, tmp_path):
    """A (2, 1) mesh of two gloo ranks sharing the card: the f32
    ResNet-18@32 step with K1/K2 (20 + 20 a rank), with ghost statistics
    of the first 2 rows of the global batch (rank 1 holds none of them and
    launches no K1) and with the flax route (the library's synchronised
    statistics), each against the one-process step on the card."""
    import dataclasses

    from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
    from learning_embeddings_tpu_torch.parallel.launch import run_ranks
    from learning_embeddings_tpu_torch.parallel.programs import (
        classifier_run)
    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig)

    lm = toy_labelmap(3, 3)
    base = ClassifierConfig(backbone="resnet18", lr=1e-3, image_size=32,
                            batch_size=8, dtype=torch.float32)
    cases = [dict(labelmap=lm, cfg=dataclasses.replace(base, **kw),
                  batches=[_cls_batch(lm, 8, 32, 0)])
             for kw in ({}, {"bn_stats_rows": 2}, {"bn_impl": "flax"})]
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False   # f32 tolerances: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        one = [classifier_run(**kw) for kw in cases]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    res = run_ranks("learning_embeddings_tpu_torch.parallel.programs:"
                    "classifier_cases", 2,
                    dict(n_data=2, n_model=1, cases=cases, device="cuda",
                         full_f32=True),
                    workdir=str(tmp_path), device="cuda", backend="gloo",
                    timeout_s=600)
    for i, name in enumerate(("fused", "ghost", "flax")):
        for rank, r in enumerate(res):
            got = r[i]
            np.testing.assert_allclose(got["losses"], one[i]["losses"],
                                       rtol=1e-5, err_msg=name)
            for k, v in got["running"].items():
                np.testing.assert_array_equal(v, res[0][i]["running"][k])
                np.testing.assert_allclose(v, one[i]["running"][k],
                                           rtol=1e-5, atol=1e-6)
            c = got["counts"]
            assert c["collective_bn_stats"] == c["collective_bn_corr"] == 20
            want_k1 = {"fused": 20, "ghost": 20 if rank == 0 else 0,
                       "flax": 0}[name]
            assert (c["bn_stats"], c["bn_corr"]) == (
                want_k1, 0 if name == "flax" else 20), (name, rank)


def test_k3_tiles_on_a_mesh_equal_the_whole(gen, tmp_path):
    """The order eval's energies at 344 × 5286, D = 10, tiled over a
    (2, 2) mesh of gloo ranks on the card, gathered: bit for bit the
    one-process kernel's, one exact_d launch a rank."""
    from learning_embeddings_tpu_torch.parallel.launch import run_ranks

    u = torch.randn((344, 10), device="cuda", generator=gen)
    v = torch.randn((5286, 10), device="cuda", generator=gen)
    whole = k3.pairwise_order(u, v).cpu().numpy()
    res = run_ranks("learning_embeddings_tpu_torch.parallel.programs:"
                    "pairwise_tiles", 4,
                    dict(n_data=2, n_model=2, device="cuda", kind="order",
                         u=u.cpu().numpy(), v=v.cpu().numpy()),
                    workdir=str(tmp_path), device="cuda", backend="gloo",
                    timeout_s=600)
    for r in res:
        np.testing.assert_array_equal(r["E"], whole)
        assert r["counts"]["pairwise_order"] == 1
        assert r["counts"]["pairwise_order_exact_d"] == 1


def test_batch_norm_spans_time_within_the_steps_wall_clock(gen):
    """Under a profiler the BatchNorm epilogues' device spans time their
    passes by event pairs: 53 + 53 a ResNet-50 step, one optimizer span,
    and together no more than the synchronised wall-clock of the steps."""
    from torch.profiler import ProfilerActivity, profile

    from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig, ClassifierTrainer)
    from learning_embeddings_tpu_torch.utils import profiling

    lm = toy_labelmap(2, 3)
    tr = ClassifierTrainer(lm, ClassifierConfig(
        backbone="resnet50", image_size=128, batch_size=16, device="cuda"))
    b = tr.put_batch(*_cls_batch(lm, 16, 128, 0))
    tr.train_step(tr.state, *b)
    torch.cuda.synchronize()
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        for _ in range(3):
            tr.train_step(tr.state, *b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    got = {n: [profiling.device_ms(r) for r in profiling.spans(n)]
           for n in ("bn.fwd_epilogue", "bn.bwd_epilogue",
                     "classifier.optimizer")}
    assert [len(v) for v in got.values()] == [3 * 53, 3 * 53, 3]
    assert all(ms is not None and ms > 0 for v in got.values() for ms in v)
    assert sum(got["bn.fwd_epilogue"]) + sum(got["bn.bwd_epilogue"]) \
        <= wall_ms
    profiling.clear_spans()
