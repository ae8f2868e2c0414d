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
from learning_embeddings_tpu_torch.utils import profiling

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


def _since(before, *names):
    """The counters `names` (``profiling.counts()``) since `before`."""
    now = profiling.counts()
    return tuple(now[k] - before[k] for k in names)


@pytest.mark.parametrize("shape", K3_SHAPES, ids=str)
def test_pairwise_order_kernel_matches_plain(gen, shape):
    m, n, d = shape
    ui = torch.randint(-3, 4, (m, d), device="cuda", generator=gen).float()
    vi = torch.randint(-3, 4, (n, d), device="cuda", generator=gen).float()
    before = profiling.counts()
    got = k3.pairwise_order(ui, vi)
    torch.cuda.synchronize()
    exact = int(bool(m and n) and k3.route_for(d) == "exact_d")
    generic = int(bool(m and n) and k3.route_for(d) == "generic")
    assert _since(before, "pairwise_order", "pairwise_order_exact_d",
                  "pairwise_order_generic") == (exact + generic, exact,
                                                generic)
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
    before = profiling.counts()
    got = k3.pairwise_order_generic(ui, vi)
    torch.cuda.synchronize()
    assert _since(before, "pairwise_order_exact_d",
                  "pairwise_order_generic") == (0, 1)
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
            before = profiling.counts()
            loss, _, _ = tr.train_batch(batch[:, 0], batch[:, 1])
            torch.cuda.synchronize()
            out[dev] = (loss, tr.embedder.embedding.detach().cpu(),
                        tr.label_embeddings().cpu(),
                        _since(before, "bn_stats", "bn_corr"))
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
    before = profiling.counts()
    run_label_embedding(lm, splits, cfg, n_epochs=2, **kw)
    res = run_label_embedding(lm, splits, cfg, n_epochs=3, resume=True, **kw)
    torch.cuda.synchronize()
    # 2 + 1 per-epoch reconstructions and one final one per run
    assert _since(before, "pairwise_order", "pairwise_order_exact_d") == \
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
        before = profiling.counts()
        rec = tr.reconstruction()
        torch.cuda.synchronize()
        launched = _since(before, "pairwise_order", "pairwise_order_exact_d")
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
    before = profiling.counts()
    run_classifier(lm, datasets, "", cfg, n_epochs=2, **kw)
    torch.cuda.synchronize()
    assert _since(before, "bn_stats", "bn_corr") == (2 * 4 * 20, 2 * 4 * 20)
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
        before = profiling.counts()
        t.classification_metrics()
        t.classification_metrics(val_paths, val)
        t.reconstruction()
        torch.cuda.synchronize()
        launched = _since(before, "pairwise_order", "pairwise_order_exact_d")
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

    before = profiling.counts()
    res = fashion_mnist.main([
        "--experiment_dir", str(tmp_path), "--experiment_name", "f",
        "--n_epochs", "1", "--loss", "multi_level", "--set_mode", "train",
        "--debug", "--image_size", "32", "--batch_size", "32",
        "--data_root", str(tmp_path / "none")])
    torch.cuda.synchronize()
    assert "synthetic stand-in" in capsys.readouterr().out
    steps = res["train_steps"]
    assert steps > 10
    assert _since(before, "bn_stats", "bn_corr") == (20 * steps, 20 * steps)
    assert _since(before, "channels_last_copies") == (0,)
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
            before = profiling.counts()
            maps = inference.occlusion_maps(tr, img, ll, slices)
            probs = inference.lime_predict(tr, slices)(
                np.repeat(img.astype(np.float32) / 255.0, 3, axis=0))
            assert _since(before, "bn_stats", "bn_corr") == (0, 0)
            out[dev] = (maps, probs)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert out["cuda"][0].shape == (lm.n_levels, 4, 4)   # patch 16, stride 16
    for got, want in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


#: per-image (R, C) of ResNet-50@448's 53 BatchNorm layers (12 shapes)
RESNET50_448_BN = [(50176, 64), (12544, 64), (12544, 128), (12544, 256),
                   (3136, 128), (3136, 256), (3136, 512), (784, 256),
                   (784, 512), (784, 1024), (196, 512), (196, 2048)]


def _ulp(v, dtype):
    """One unit in the last place of |v| in `dtype` (bf16 or f32)."""
    bits = {torch.bfloat16: 7, torch.float32: 23}[dtype]
    return torch.ldexp(torch.ones_like(v), torch.frexp(v.abs())[1] - 1 - bits)


def _dx_inputs(R, C, dtype, gen, images=None):
    """dy, x (R, C) of `dtype` and the per-channel vectors of one
    BatchNorm backward, from the data: statistics over the first `images`
    rows (all for None) and sums over all rows."""
    x = (0.5 + 1.5 * torch.randn((R, C), device="cuda", generator=gen)) \
        .to(dtype)
    dy = torch.randn((R, C), device="cuda", generator=gen).to(dtype)
    n = R if images is None else images
    s, q = bn._stats_plain(x[:n])
    mean = s / n
    d = q / n - mean * mean
    inv = torch.rsqrt(torch.clamp_min(d, 0.0) + 1e-5)
    scale = 1 + 0.2 * torch.randn(C, device="cuda", generator=gen)
    sdy, sdyx = bn._corr_plain(dy, x)
    return dy, x, scale, mean, inv, sdy, sdyx, d


@pytest.mark.parametrize("R,C", [(r * 2, c) for r, c in RESNET50_448_BN]
                         + [(12345, 100)], ids=str)
def test_bn_dx_matches_plain(gen, R, C):
    """The dx kernel against `_dx_plain` at ResNet-50@448's BatchNorm
    shapes (batch 2) and a ragged one, bf16 and f32 inputs, the plain
    route and the ghost route (a row prefix, x rounded to bf16, one
    channel clamped): at most one ulp of dx's dtype per element beyond
    the f32 rounding of the terms it sums (2^-21 of their magnitude:
    Triton contracts a·b + c into one FMA where eager PyTorch rounds the
    product first, and computes the per-channel coefficients in another
    order). The scale's gradient agrees likewise; one launch each."""
    for dtype in (torch.bfloat16, torch.float32):
        for ghost in (False, True):
            rows = R // 3 if ghost else R
            dy, x, scale, mean, inv, sdy, sdyx, d = _dx_inputs(
                R, C, dtype, gen, rows if ghost else None)
            if ghost:
                d[0] = -1e-3
            args = (dy, x, scale, mean, inv, sdy, sdyx, sdy, sdyx, rows,
                    rows, d if ghost else None, ghost)
            dy0, x0 = dy.clone(), x.clone()
            before = profiling.counts()
            got, dscale = bn_triton.bn_dx(*args)
            torch.cuda.synchronize()
            assert _since(before, "bn_dx") == (1,)
            want, dscale_want = bn._dx_plain(*args)
            assert got.dtype == dtype and got.shape == (R, C)
            g = (scale * inv).abs()
            terms = (dy.float().abs() * g + (g * sdy / rows).abs()
                     + (x.float() - mean).abs() * g * inv * inv
                     * (sdyx.abs() + (mean * sdy).abs()) / rows)
            err = (got.float() - want.float()).abs()
            tol = _ulp(torch.maximum(got.float().abs(), want.float().abs()),
                       dtype) + 2.0 ** -21 * terms
            assert bool((err <= tol).all()), (dtype, ghost,
                                              err.max().item())
            torch.testing.assert_close(dscale, dscale_want, rtol=1e-5,
                                       atol=1e-5 * dscale_want.abs().max())
            assert torch.equal(dy, dy0) and torch.equal(x, x0)


#: the coefficients bn_act folds: train mode from sums over all rows,
#: from a third of them (the ghost prefix) in f32 and with the bf16
#: statistics' rounding, and eval mode's running statistics
ACT_COEFFS = ("train", "ghost_f32", "ghost_bf16", "eval")


def _act_coeffs(x, kind, gen):
    """(u, v, n, round_stats) of bn_act for an (R, C) x."""
    R, C = x.shape
    if kind == "eval":
        return (0.3 * torch.randn(C, device="cuda", generator=gen),
                0.5 + torch.rand(C, device="cuda", generator=gen), None,
                False)
    rows = R if kind == "train" else max(R // 3, 1)
    round_stats = kind == "ghost_bf16"
    xs = x[:rows].to(torch.bfloat16) if round_stats else x[:rows]
    return (*bn._stats_plain(xs, round_stats), rows, round_stats)


@pytest.mark.parametrize("R,C", [(r * 2, c) for r, c in RESNET50_448_BN]
                         + [(12345, 100)], ids=str)
def test_bn_act_matches_plain(gen, R, C):
    """The act kernel against `_act_plain` (the unfused chain) at
    ResNet-50@448's BatchNorm shapes (batch 2) and a ragged one, bf16 and
    f32 inputs, train coefficients (all rows; a ghost prefix in f32 and
    with bf16 statistics) and eval coefficients, with and without the
    residual and the ReLU: within one ulp of y in x's dtype (and one of
    the output after the residual add); the train statistics it writes
    within f32 rounding; one launch each, x and the residual untouched."""
    for dtype in (torch.bfloat16, torch.float32):
        x = (0.5 + 1.5 * torch.randn((R, C), device="cuda", generator=gen)) \
            .to(dtype)
        r = torch.randn((R, C), device="cuda", generator=gen).to(dtype)
        scale = 1 + 0.2 * torch.randn(C, device="cuda", generator=gen)
        bias = 0.1 * torch.randn(C, device="cuda", generator=gen)
        x0, r0 = x.clone(), r.clone()
        for kind in ACT_COEFFS:
            u, v, n, rs = _act_coeffs(x, kind, gen)
            y, _ = bn._act_plain(x, scale, bias, 1e-5, u, v, n, rs,
                                 relu=False)
            for res in (None, r):
                for relu in (False, True):
                    before = profiling.counts()
                    got, stats = bn_triton.bn_act(x, scale, bias, 1e-5, u, v,
                                                  n, rs, res, relu)
                    torch.cuda.synchronize()
                    assert _since(before, "bn_act") == (1,)
                    want, want_stats = bn._act_plain(
                        x, scale, bias, 1e-5, u, v, n, rs, res, relu)
                    assert got.dtype == dtype and got.shape == (R, C)
                    err = (got.float() - want.float()).abs()
                    tol = _ulp(y.float(), dtype) + (0 if res is None else _ulp(
                        torch.maximum(got.float().abs(), want.float().abs()),
                        dtype))
                    assert bool((err <= tol).all()), (
                        dtype, kind, res is not None, relu, err.max().item())
                    if n is None:
                        assert stats is None and want_stats is None
                        continue
                    mean, var, inv, d = want_stats
                    for g, w, mag in zip(stats, want_stats,
                                         (mean, var, inv, v / n)):
                        assert bool(((g - w).abs() <= 2.0 ** -21
                                     * mag.abs()).all()), kind
        assert torch.equal(x, x0) and torch.equal(r, r0)


def test_bn_act_passes_nan(gen):
    """A NaN in x or in the residual comes out as NaN through the ReLU,
    as F.relu passes it; the other elements are the plain version's."""
    R, C = 4096, 64
    x = torch.randn((R, C), device="cuda", generator=gen).to(torch.bfloat16)
    r = torch.randn((R, C), device="cuda", generator=gen).to(torch.bfloat16)
    x[3, 5] = float("nan")
    r[7, 9] = float("nan")
    ones, zeros = torch.ones(C, device="cuda"), torch.zeros(C, device="cuda")
    for u, v, n in ((zeros, ones, None), (zeros, ones * R, R)):
        for res in (None, r):
            got, _ = bn_triton.bn_act(x, ones, zeros, 1e-5, u, v, n,
                                      residual=res)
            want, _ = bn._act_plain(x, ones, zeros, 1e-5, u, v, n,
                                    residual=res)
            nan = torch.isnan(want)
            assert torch.equal(torch.isnan(got), nan)
            assert bool(nan[3, 5]) and bool(nan[7, 9]) == (res is not None)
            assert torch.equal(got[~nan], want[~nan])


def test_act_allocates_only_its_output_on_the_card(gen):
    """The forward epilogue on the card holds no f32 activation: its peak
    above the inputs is the output (x's dtype) and a few (C,) vectors."""
    N, C, H, W = 8, 64, 112, 112
    x = torch.randn((N, H, W, C), device="cuda", generator=gen) \
        .to(torch.bfloat16).permute(0, 3, 1, 2)
    r = torch.randn((N, H, W, C), device="cuda", generator=gen) \
        .to(torch.bfloat16).permute(0, 3, 1, 2)
    v = [torch.rand(C, device="cuda", generator=gen) + 0.5
         for _ in range(4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, stats = bn._act(x, *v[:2], 1e-5, *v[2:], N * H * W, False, r)
    torch.cuda.synchronize()
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert out.dtype == torch.bfloat16 and len(stats) == 4
    assert torch.cuda.max_memory_allocated() - base <= x.nbytes + 2 ** 20


def test_dx_allocates_only_its_output_on_the_card(gen):
    """The backward epilogue on the card holds no f32 activation: its
    peak above the inputs is dx (x's dtype) and a few (C,) vectors."""
    N, C, H, W = 8, 64, 112, 112
    x = torch.randn((N, H, W, C), device="cuda", generator=gen) \
        .to(torch.bfloat16).permute(0, 3, 1, 2)
    dy = torch.randn((N, H, W, C), device="cuda", generator=gen) \
        .to(torch.bfloat16).permute(0, 3, 1, 2)
    v = [torch.rand(C, device="cuda", generator=gen) + 0.5
         for _ in range(7)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dx, dscale, dbias = bn._dx(dy, x, *v, N * H * W, N * H * W)
    torch.cuda.synchronize()
    assert dx.is_contiguous(memory_format=torch.channels_last)
    assert dx.dtype == torch.bfloat16
    assert torch.cuda.max_memory_allocated() - base <= x.nbytes + 2 ** 20


@pytest.mark.parametrize("R,C", [(12345, 100), (401408, 64), (25088, 2048)])
def test_bn_stats_bf16_rounding_variant_matches_plain(gen, R, C):
    """K1's rounding variant (each x² rounded to bf16 before the sum, the
    bf16 BatchNorm statistics): equal to its plain version on values whose
    squares and sums are exact, within 1e-5·Σ|terms| on normal ones, and
    counted as a K1 launch."""
    before = profiling.counts()
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
    assert _since(before, "bn_stats", "bn_stats_rounded") == (2, 2)


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
    before = profiling.counts()
    _, loss = tr.train_step(tr.state, *b)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    return _since(before, "bn_stats", "bn_corr", "bn_dx", "bn_act")


def test_remat_step_launch_counts(gen):
    """A ResNet-50 step with remat: K1 and the act kernel 53 + 52 times
    (the 52 block BatchNorms recompute their forward in the backward
    pass; the stem's does not), K2 and the dx kernel 53 times (the
    backward runs once)."""
    assert _resnet50_step_counts(remat=True) == (105, 53, 53, 105)
    assert _resnet50_step_counts() == (53, 53, 53, 53)


def test_flax_route_launches_no_bn_kernel(gen):
    """The flax route launches none of the four; its ghost statistics
    (which take the port's route) launch each once a BatchNorm."""
    assert _resnet50_step_counts(bn_impl="flax") == (0, 0, 0, 0)
    assert _resnet50_step_counts(bn_impl="flax", bn_stats_rows=2) == (
        53, 53, 53, 53)


def test_eval_forward_launches_the_act_kernel_once_a_batch_norm(gen):
    """A ResNet-50 eval step (no gradient) launches the act kernel once a
    BatchNorm with the running statistics, and no other BN kernel; its
    scores are finite."""
    from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig, ClassifierTrainer)

    lm = toy_labelmap(2, 3)
    tr = ClassifierTrainer(lm, ClassifierConfig(
        backbone="resnet50", image_size=64, batch_size=4, device="cuda"))
    b = tr.put_batch(*_cls_batch(lm, 4, 64, 0))
    profiling.reset_counts()
    loss, scores = tr.eval_step(tr.state, *b)
    torch.cuda.synchronize()
    c = profiling.counts()
    assert (c["bn_stats"], c["bn_corr"], c["bn_dx"], c["bn_act"]) == (
        0, 0, 0, 53)
    assert bool(torch.isfinite(scores).all()) and np.isfinite(float(loss))


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
            assert (c["bn_stats"], c["bn_corr"], c["bn_dx"],
                    c["bn_act"]) == (
                want_k1, *(0 if name == "flax" else 20,) * 3), (name, rank)


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


# ---------------------------------------------------------------------------
# ViT-L/16 (models/vit.py) and the attention op (ops/attention.py)
# ---------------------------------------------------------------------------

def _vit_reference():
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark.lib.vit_inputs import vit_params
    from benchmark.reference import resnet as rref
    from benchmark.reference import vit as vref
    return vit_params, vref, rref


def _rel(got, want):
    got, want = got.detach().float(), want.detach()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def test_vit_l16_at_448_matches_the_reference(gen):
    """ViT-L/16 at 448², batch 2, bf16 on the card against the f32
    reference (TF32 off): logits and every leaf's first gradient. bf16
    through 24 blocks is the stated precision, so the tolerance is what
    that precision alone does: the program may differ from the f32
    reference by at most 4× as much as the reference rounded to bf16
    where the program rounds (`bf16_round`) does, plus 1e-3; the worst
    leaf and the median leaf are held apart."""
    from learning_embeddings_tpu_torch.models.heads import HierarchicalCNN

    vit_params, vref, rref = _vit_reference()
    levels = (5, 23, 116, 200)
    arch = vref.Arch()
    w = vit_params(11, "cuda", arch, sum(levels))
    model = HierarchicalCNN("vit_l_16", levels, image_size=448).to(
        "cuda", memory_format=torch.channels_last)
    model.load_state_dict(w)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 448, 448, 3)).astype(np.uint8)
    labels = np.stack([rng.randint(0, n, 2) for n in levels], axis=1)
    x = rref.scale_images(torch.from_numpy(images).cuda())
    ll = torch.from_numpy(labels).cuda()
    logits = model.train()(x)
    rref.multi_level_ce(logits, ll, levels).backward()
    got = {k: p.grad for k, p in model.named_parameters()}

    def reference(q):
        with rref.float32_math():
            p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
            out = vref.head(p, vref.features(p, x, arch, q, recompute=True))
            g = torch.autograd.grad(rref.multi_level_ce(out, ll, levels),
                                    list(p.values()))
        return out.detach(), dict(zip(p, g))

    ref_logits, ref_grads = reference(rref.identity)
    bf_logits, bf_grads = reference(rref.bf16_round)
    assert _rel(logits, ref_logits) <= 4 * _rel(bf_logits, ref_logits) \
        + 1e-3
    gaps = {k: _rel(got[k], g) for k, g in ref_grads.items()}
    bf = {k: _rel(bf_grads[k], g) for k, g in ref_grads.items()}
    assert max(gaps.values()) <= 4 * max(bf.values()) + 1e-3, sorted(
        gaps.items(), key=lambda kv: -kv[1])[:5]
    assert np.median(list(gaps.values())) <= \
        4 * np.median(list(bf.values())) + 1e-3


def _sdpa_node(out):
    # attention's output → profiling._BackwardStarts → the fused op's own
    # node
    return out.grad_fn.next_functions[0][0].name()


def test_pinned_attention_backend_is_the_one_that_ran(gen):
    """The attention at ViT-L/16's shape runs cuDNN's kernels, the pinned
    backend (2.75× flash's speed there: tools/attention_backends.py,
    PERF.md), forward and backward, and matches the softmax math within
    bf16's rounding of the output and gradients."""
    from torch.profiler import ProfilerActivity, profile

    from learning_embeddings_tpu_torch.ops import attention as att

    q, k, v = (torch.randn(2, 16, 785, 64, device="cuda", generator=gen)
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = att.attention(q, k, v)
        out.backward(torch.ones_like(out))
        torch.cuda.synchronize()
    assert _sdpa_node(out) == "ScaledDotProductCudnnAttentionBackward0"
    names = [e.name.lower() for e in prof.events()
             if str(e.device_type).endswith("CUDA")]
    # cuDNN names its kernels "cudnn_generated_..._sdpa_..._flash_...":
    # PyTorch's own flash kernels live in the pytorch_flash namespace
    assert any("cudnn" in n for n in names), names[:20]
    assert not any(o in n for n in names
                   for o in ("pytorch_flash", "fmha_cutlass", "efficient"))
    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    want = torch.softmax(qf @ kf.transpose(-2, -1) / 8.0, -1) @ vf
    want.backward(torch.ones_like(want))
    assert _rel(out.detach(), want.detach()) <= 2 ** -7
    for got, w in ((q, qf), (k, kf), (v, vf)):
        assert _rel(got.grad, w.grad) <= 2 ** -6


@pytest.mark.parametrize("remat", [False, True])
def test_vit_train_step_launch_counts(gen, remat):
    """A ViT-L/16 train step at 448² through ``ClassifierTrainer``: the
    attention 48 times (a forward and a backward per block; 72 with
    remat), no BatchNorm kernel; then an eval step of finite scores."""
    from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig, ClassifierTrainer)

    lm = toy_labelmap(2, 3)
    tr = ClassifierTrainer(lm, ClassifierConfig(
        backbone="vit_l_16", image_size=448, batch_size=2, remat=remat,
        device="cuda"))
    b = tr.put_batch(*_cls_batch(lm, 2, 448, 0))
    profiling.reset_counts()
    tr.state, loss = tr.train_step(tr.state, *b)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    c = profiling.counts()
    assert c["attention"] == (72 if remat else 48)
    assert (c["bn_stats"], c["bn_corr"], c["bn_dx"], c["bn_act"]) == (
        0, 0, 0, 0)
    loss, scores = tr.eval_step(tr.state, *b)
    assert bool(torch.isfinite(scores).all()) and np.isfinite(float(loss))


# ---------------------------------------------------------------------------
# Swin-L (models/swin.py) and the biased attention (ops/attention.py)
# ---------------------------------------------------------------------------

def _swin_reference():
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark.lib.swin_inputs import swin_params
    from benchmark.reference import resnet as rref
    from benchmark.reference import swin as sref
    return swin_params, sref, rref


@pytest.mark.parametrize("windows, heads", [(64, 6), (4, 24), (1, 48)])
def test_biased_attention_on_the_pinned_backend(gen, windows, heads):
    """The biased call at Swin-L's stage shapes (windows folded into the
    heads, 144 tokens of 32, a (1, nW·H, N, N) bias broadcast over the
    batch) runs the pinned backend's node, and matches the softmax math
    within bf16's rounding, the bias's gradient (summed over the batch)
    included."""
    from learning_embeddings_tpu_torch.ops import attention as att

    B, N = 2, 144
    q, k, v = (torch.randn(B, windows * heads, N, 32, device="cuda",
                           generator=gen).to(torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    bias = torch.randn(1, windows * heads, N, N, device="cuda",
                       generator=gen).to(torch.bfloat16).requires_grad_(True)
    profiling.reset_counts()
    out = att.attention(q, k, v, bias)
    dout = torch.randn(out.shape, device="cuda", generator=gen).to(
        torch.bfloat16)
    out.backward(dout)
    torch.cuda.synchronize()
    assert profiling.counts()["attention_bias"] == 2
    node = _sdpa_node(out)
    assert "ScaledDotProductEfficientAttention" in node, node
    qf, kf, vf, bf = (t.detach().float().requires_grad_(True)
                      for t in (q, k, v, bias))
    want = torch.softmax(qf @ kf.transpose(-2, -1) / 32 ** 0.5 + bf,
                         -1) @ vf
    want.backward(dout.float())
    assert _rel(out.detach(), want.detach()) <= 2 ** -7
    for got, w in ((q, qf), (k, kf), (v, vf), (bias, bf)):
        assert got.grad.shape == got.shape
        assert _rel(got.grad, w.grad) <= 2 ** -6


#: Swin-L at 384² (window 12): (windows, heads, grid) of each stage
SWIN_L_STAGES = [(64, 6, 96), (16, 12, 48), (4, 24, 24), (1, 48, 12)]


def _window_inputs(gen, windows, heads, grid, shifted, B=4, d=32):
    """qkv (B, nW, 144, 3C) bf16 and the block's B + M bias (1, nW·H, 144,
    144) bf16, both taking a gradient: the bias from a table of std 0.5
    (the cell's), with the shift's mask where `shifted`; and dO."""
    from learning_embeddings_tpu_torch.models import swin

    N, C = 144, heads * d
    qkv = torch.randn(B, windows, N, 3 * C, device="cuda",
                      generator=gen).to(torch.bfloat16).requires_grad_(True)
    att = swin.ShiftedWindowAttention(C, heads, 12).cuda()
    with torch.no_grad():
        att.relative_position_bias_table.copy_(torch.randn(
            att.relative_position_bias_table.shape, device="cuda",
            generator=gen) * 0.5)
    mask = swin.shift_mask(grid, 12, 6).cuda() if shifted else None
    bias = att.bias(mask, windows).detach().to(torch.bfloat16) \
        .requires_grad_(True)
    dout = torch.randn(B, windows, N, C, device="cuda", generator=gen).to(
        torch.bfloat16)
    return qkv, bias, dout


def _window_grads(fn, qkv, bias, dout, heads):
    for t in (qkv, bias):
        t.grad = None
    out = fn(qkv, bias, heads)
    out.backward(dout)
    torch.cuda.synchronize()
    return out.detach(), qkv.grad, bias.grad


@pytest.mark.parametrize("windows, heads, grid, shifted", [
    (w, h, g, s) for w, h, g in SWIN_L_STAGES
    for s in ((True, False) if g > 12 else (False,))],
    ids=lambda v: str(v))
def test_window_attention_kernel_matches_plain(gen, windows, heads, grid,
                                               shifted):
    """The kernel pair at each of Swin-L's four stage shapes (nW·H 384,
    192, 96, 48; 144 tokens of 32), B 4, shifted and not, against the plain
    route on the same bf16 inputs (f32 scores and softmax, each output
    rounded once): the output within 2^-7 of its norm, as the pinned
    backend's biased call is held (the kernel rounds P to bf16 for P·v, as
    that kernel does); the packed qkv gradient and the bias's gradient
    within 2^-6 (P and dS rounded to bf16 for their products). Each pass
    counts once as "window_attention"; the ragged stage shapes run in one
    chunk or several (``launch_plan``)."""
    from learning_embeddings_tpu_torch.ops import window_attention as wa

    qkv, bias, dout = _window_inputs(gen, windows, heads, grid, shifted)
    before = profiling.counts()
    got = _window_grads(wa.window_attention, qkv, bias, dout, heads)
    assert _since(before, "window_attention", "attention",
                  "attention_bias") == (2, 2, 2)
    want = _window_grads(wa.window_attention_plain, qkv, bias, dout, heads)
    assert got[0].shape == want[0].shape and got[1].shape == qkv.shape
    assert got[2].dtype == torch.bfloat16 and got[2].shape == bias.shape
    assert _rel(got[0], want[0].float()) <= 2 ** -7
    assert _rel(got[1], want[1].float()) <= 2 ** -6
    assert _rel(got[2], want[2].float()) <= 2 ** -6


@pytest.mark.parametrize("N, d", [(49, 32), (144, 64), (16, 16)],
                         ids=["window_7", "head_64", "window_4_head_16"])
def test_window_attention_kernel_at_other_shapes(gen, N, d):
    """The kernel pair at shapes Swin-L does not use, each built for its
    own (N, d): 49 tokens (window 7: rows and keys past N masked, the
    bias read element by element), head width 64 (the backward in one
    shared-memory stage) and 16: against the plain route, as above."""
    from learning_embeddings_tpu_torch.ops import window_attention as wa

    B, nW, H = 3, 4, 3
    qkv = torch.randn(B, nW, N, 3 * H * d, device="cuda",
                      generator=gen).to(torch.bfloat16).requires_grad_(True)
    bias = (torch.randn(1, nW * H, N, N, device="cuda", generator=gen)
            * 0.5).to(torch.bfloat16).requires_grad_(True)
    dout = torch.randn(B, nW, N, H * d, device="cuda", generator=gen).to(
        torch.bfloat16)
    got = _window_grads(wa.window_attention, qkv, bias, dout, H)
    want = _window_grads(wa.window_attention_plain, qkv, bias, dout, H)
    assert _rel(got[0], want[0].float()) <= 2 ** -7
    assert _rel(got[1], want[1].float()) <= 2 ** -6
    assert _rel(got[2], want[2].float()) <= 2 ** -6


def test_window_attention_bias_gradient_beats_the_pinned_backend(gen):
    """At stage 1's shape (B 4, shifted) the kernel's bias gradient, summed
    over the images in f32 and rounded once, lies at least as close to an
    f32 reference on the same bf16 inputs as the memory-efficient SDPA
    route's (a bf16 gradient per image, then summed), and so do its output
    and qkv gradient within 1.5× of that route's (both round P and dS to
    bf16 for their products). Two runs give the same bits (no atomics)."""
    from learning_embeddings_tpu_torch.ops import attention as att
    from learning_embeddings_tpu_torch.ops import window_attention as wa

    windows, heads, grid = SWIN_L_STAGES[0]
    qkv, bias, dout = _window_inputs(gen, windows, heads, grid, True)

    def sdpa(qkv, bias, heads):
        B, nW, N, C3 = qkv.shape
        q, k, v = qkv.view(B, nW, N, 3, heads, -1).permute(
            3, 0, 1, 4, 2, 5).reshape(3, B, nW * heads, N, -1).unbind(0)
        return att.attention(q, k, v, bias).view(B, nW, heads, N, -1) \
            .transpose(2, 3).reshape(B, nW, N, C3 // 3)

    got = _window_grads(wa.window_attention, qkv, bias, dout, heads)
    again = _window_grads(wa.window_attention, qkv, bias, dout, heads)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    lib = _window_grads(sdpa, qkv, bias, dout, heads)
    qf, bf = (t.detach().float().requires_grad_(True) for t in (qkv, bias))
    want = _window_grads(wa.window_attention_plain, qf, bf, dout.float(),
                         heads)
    gaps = [(_rel(g, w), _rel(s, w)) for g, s, w in zip(got, lib, want)]
    assert gaps[2][0] <= gaps[2][1], gaps
    assert all(g <= 1.5 * s for g, s in gaps[:2]), gaps


def test_window_attention_bias_without_gradient(gen):
    """A bias that takes no gradient (as ``no_relative_bias`` plants one in
    the unshifted blocks) is passed through: no bias gradient, the same
    qkv gradient bit for bit."""
    from learning_embeddings_tpu_torch.ops import window_attention as wa

    windows, heads, grid = SWIN_L_STAGES[1]
    qkv, bias, dout = _window_inputs(gen, windows, heads, grid, True)
    _, dqkv, _ = _window_grads(wa.window_attention, qkv, bias, dout, heads)
    fixed = bias.detach()
    out = wa.window_attention(qkv, fixed, heads)
    qkv.grad = None
    out.backward(dout)
    torch.cuda.synchronize()
    assert fixed.grad is None and torch.equal(qkv.grad, dqkv)


@pytest.mark.parametrize("case", ["f32", "tokens", "head_width",
                                  "bias_shape", "bias_strided",
                                  "bias_dtype"])
def test_window_attention_refuses(gen, case):
    """The kernel route raises where it cannot take the inputs: there is
    no fallback."""
    from learning_embeddings_tpu_torch.ops import window_attention as wa

    B, nW, H, N, d = 2, 4, 2, 144, 32
    if case == "tokens":
        N = 145
    if case == "head_width":
        d = 8
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    qkv = torch.randn(B, nW, N, 3 * H * d, device="cuda",
                      generator=gen).to(dtype)
    bias = torch.zeros(1, nW * H, N, N, device="cuda", dtype=dtype)
    if case == "bias_shape":
        bias = bias[:, :-1]
    if case == "bias_strided":
        bias = torch.zeros(1, nW * H, N, 2 * N, device="cuda",
                           dtype=dtype)[..., ::2]
    if case == "bias_dtype":
        bias = bias.float()
    match = {"f32": "bf16", "tokens": "tokens", "head_width": "head width",
             "bias_shape": "expected", "bias_strided": "contiguous",
             "bias_dtype": "dtype"}[case]
    before = profiling.counts()
    with pytest.raises(ValueError, match=match):
        wa.window_attention(qkv, bias, H)
    assert _since(before, "window_attention") == (0,)


def test_swin_l_at_384_matches_the_reference(gen):
    """Swin-L at 384², batch 2, bf16 on the card against the f32
    reference: logits and every leaf's gradient (the 24 bias tables'
    included) no further from the reference than 4× the reference rounded
    to bf16 where the program rounds, plus 1e-3; worst and median leaf."""
    from learning_embeddings_tpu_torch.models.heads import HierarchicalCNN

    swin_params, sref, rref = _swin_reference()
    levels = (5, 23, 116, 200)
    arch = sref.Arch()
    w = swin_params(11, "cuda", arch, sum(levels))
    model = HierarchicalCNN("swin_l", levels, image_size=384).to(
        "cuda", memory_format=torch.channels_last)
    model.load_state_dict(w)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 384, 384, 3)).astype(np.uint8)
    labels = np.stack([rng.randint(0, n, 2) for n in levels], axis=1)
    x = rref.scale_images(torch.from_numpy(images).cuda())
    ll = torch.from_numpy(labels).cuda()
    logits = model.train()(x)
    rref.multi_level_ce(logits, ll, levels).backward()
    got = {k: p.grad for k, p in model.named_parameters()}

    def reference(q):
        with rref.float32_math():
            p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
            out = sref.head(p, sref.features(p, x, arch, q, recompute=True))
            g = torch.autograd.grad(rref.multi_level_ce(out, ll, levels),
                                    list(p.values()))
        return out.detach(), dict(zip(p, g))

    ref_logits, ref_grads = reference(rref.identity)
    bf_logits, bf_grads = reference(rref.bf16_round)
    assert _rel(logits, ref_logits) <= 4 * _rel(bf_logits, ref_logits) \
        + 1e-3
    gaps = {k: _rel(got[k], g) for k, g in ref_grads.items()}
    bf = {k: _rel(bf_grads[k], g) for k, g in ref_grads.items()}
    assert max(gaps.values()) <= 4 * max(bf.values()) + 1e-3, sorted(
        gaps.items(), key=lambda kv: -kv[1])[:5]
    assert np.median(list(gaps.values())) <= \
        4 * np.median(list(bf.values())) + 1e-3


@pytest.mark.parametrize("remat", [False, True])
def test_swin_train_step_counts(gen, remat):
    """A Swin-L train step at 384² through ``ClassifierTrainer``: the
    biased attention 48 times (72 with remat), the windows 96 (144), no
    BatchNorm kernel; then an eval step of finite scores."""
    from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig, ClassifierTrainer)

    lm = toy_labelmap(2, 3)
    tr = ClassifierTrainer(lm, ClassifierConfig(
        backbone="swin_l", image_size=384, batch_size=2, remat=remat,
        device="cuda"))
    b = tr.put_batch(*_cls_batch(lm, 2, 384, 0))
    profiling.reset_counts()
    tr.state, loss = tr.train_step(tr.state, *b)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    c = profiling.counts()
    assert c["attention"] == c["attention_bias"] == (72 if remat else 48)
    # every window attention through the kernel pair
    assert c["window_attention"] == (72 if remat else 48)
    assert c["swin_windows"] == (144 if remat else 96)
    assert (c["bn_stats"], c["bn_corr"], c["bn_dx"], c["bn_act"]) == (
        0, 0, 0, 0)
    loss, scores = tr.eval_step(tr.state, *b)
    assert bool(torch.isfinite(scores).all()) and np.isfinite(float(loss))


# ---------------------------------------------------------------------------
# host → card copies through the pinned ring (utils/staging.py)
# ---------------------------------------------------------------------------

#: the train cell's batch: 128 × 448² × 3 uint8, 77 MB
H2D_B, H2D_S = 128, 448


@pytest.fixture(scope="module")
def h2d():
    """(labelmap, images, int32 labels, f32 multi-hot, a ResNet-18
    trainer at 448²) for the copy tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the copy path under test is the "
                    "card's)")
    from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig, ClassifierTrainer)

    lm = toy_labelmap(2, 3)
    tr = ClassifierTrainer(lm, ClassifierConfig(
        backbone="resnet18", image_size=H2D_S, batch_size=H2D_B,
        device="cuda"))
    return (lm, *_cls_batch(lm, H2D_B, H2D_S, 21), tr)


def _h2d_case(h2d, case):
    _, imgs, ll, mh, _ = h2d
    return {"uint8_images": (imgs, None),
            "int32_labels_to_int64": (ll, torch.int64),
            "f32_multihot": (mh, torch.float32),
            "height_split_view": (imgs[:, H2D_S // 2:], None),
            "ragged_38_rows": (imgs[:38], None)}[case]


@pytest.mark.parametrize("case", ["uint8_images", "int32_labels_to_int64",
                                  "f32_multihot", "height_split_view",
                                  "ragged_38_rows"])
def test_to_device_equals_a_blocking_copy(gen, h2d, case):
    """Through the pinned ring, bit for bit what a blocking ``.to()``
    gives: the dtype converted, strides gathered, one staged copy."""
    from learning_embeddings_tpu_torch.train.classifier import to_device

    a, dtype = _h2d_case(h2d, case)
    before = profiling.counts()
    got = to_device(a, "cuda", dtype)
    plain = torch.as_tensor(a)
    want = plain.to("cuda", dtype=dtype or plain.dtype)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.is_contiguous() and torch.equal(got, want)
    assert _since(before, "copy_pinned") == (1,)


@pytest.mark.parametrize("rows", [H2D_B, 38])
def test_put_batch_equals_blocking_copies(gen, h2d, rows):
    """``put_batch`` of the whole and of a ragged batch: three staged
    copies, each bit-equal to a blocking one."""
    _, imgs, ll, mh, tr = h2d
    before = profiling.counts()
    got = tr.put_batch(imgs[:rows], ll[:rows], mh[:rows])
    want = (torch.as_tensor(imgs[:rows]).cuda(),
            torch.as_tensor(ll[:rows]).to("cuda", torch.int64),
            torch.as_tensor(mh[:rows]).to("cuda", torch.float32))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert _since(before, "copy_pinned") == (3,)


def test_put_batch_returns_while_the_stream_is_busy(gen, h2d):
    """With ~0.5 s of work queued on the current stream, ``put_batch`` of
    the 77 MB batch returns before that work ends: it waits neither for
    the stream nor for its copy. The tensors are exact afterwards."""
    _, imgs, ll, mh, tr = h2d
    tr.put_batch(imgs, ll, mh)
    torch.cuda.synchronize()
    torch.cuda._sleep(10 ** 9)
    busy = torch.cuda.Event()
    busy.record()
    got = tr.put_batch(imgs, ll, mh)
    assert not busy.query()
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), torch.as_tensor(imgs))
    assert torch.equal(got[1].cpu(), torch.as_tensor(ll).long())
    assert torch.equal(got[2].cpu(), torch.as_tensor(mh))


def test_the_consumer_stream_waits_for_the_copy(gen, h2d):
    """With the copy stream held back, work queued on the current stream
    right after ``to_device`` still reads the copied bytes."""
    from learning_embeddings_tpu_torch.train.classifier import to_device
    from learning_embeddings_tpu_torch.utils import staging

    a = np.random.RandomState(8).randint(
        0, 256, (H2D_B, H2D_S, H2D_S, 3)).astype(np.uint8)
    with torch.cuda.stream(staging._ring(torch.device("cuda")).stream):
        torch.cuda._sleep(2 * 10 ** 8)
    total = to_device(a, "cuda").sum(dtype=torch.int64)
    assert int(total) == int(a.sum(dtype=np.int64))


def test_copies_keep_their_bytes_while_the_consumer_lags(gen, h2d):
    """Six copies of distinct 77 MB arrays (more than the ring holds),
    each read by the current stream behind ~0.5 s of queued work and
    released at once: no ring bytes and no device block are used again
    before the reads, so each read finds its own array."""
    from learning_embeddings_tpu_torch.train.classifier import to_device

    shape = (H2D_B, H2D_S, H2D_S, 3)
    arrays = []
    for k in range(6):
        a = np.full(shape, 17 * k + 3, np.uint8)
        a[k] = np.random.RandomState(k).randint(0, 256, shape[1:])
        arrays.append(a)
    reads = torch.empty((6,) + shape, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    torch.cuda._sleep(10 ** 9)
    busy = torch.cuda.Event()
    busy.record()
    for k, a in enumerate(arrays):
        out = to_device(a, "cuda")
        reads[k].copy_(out)
        del out
    assert not busy.query()
    torch.cuda.synchronize()
    for k, a in enumerate(arrays):
        assert torch.equal(reads[k].cpu(), torch.as_tensor(a))


def test_train_steps_never_wait_for_the_ring(gen, h2d):
    """Twenty ResNet-18@448 train steps at batch 128: three staged copies
    a step, and the host never waits for ring bytes still in flight."""
    _, imgs, ll, mh, tr = h2d
    tr.state, loss = tr.train_step(tr.state, *tr.put_batch(imgs, ll, mh))
    torch.cuda.synchronize()
    before = profiling.counts()
    for _ in range(20):
        tr.state, loss = tr.train_step(tr.state,
                                       *tr.put_batch(imgs, ll, mh))
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    assert _since(before, "copy_pinned", "copy_pinned_wait") == (60, 0)


def test_threads_copying_at_once_each_get_their_own_bytes(gen):
    """Sixteen threads (more than the host's cores, the interpreter
    switching every microsecond) copy distinct arrays through the one
    ring at once, as the joint's prefetch thread does beside the main
    thread: every copy reads back as its own array."""
    import sys
    import threading

    from learning_embeddings_tpu_torch.train.classifier import to_device

    def work(k, out):
        rng = np.random.RandomState(100 + k)
        for i in range(8):
            a = rng.randint(0, 256, (24 + k, 300, 200, 3)).astype(np.uint8)
            got = to_device(a, "cuda")
            out.append(bool(torch.equal(got.cpu(), torch.as_tensor(a))))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        results = [[] for _ in range(16)]
        threads = [threading.Thread(target=work, args=(k, results[k]))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert results == [[True] * 8] * 16
