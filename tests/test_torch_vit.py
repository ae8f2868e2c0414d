"""The port's ViT trunk (``models/vit.py``) and attention op
(``ops/attention.py``) on the CPU, held against the benchmark's plain
reference (``benchmark/reference/vit.py``: the one copy, which imports
nothing of the port) at a small size: 2 blocks of width 64, 4 heads of
16, MLP 128, patch 8, 32² images (17 tokens), batch 4, float32, seeded
random weights (``benchmark/lib/vit_inputs.py``).

Tolerances, each for a reason:
* logits rtol/atol 1e-5: the same f32 arithmetic in another order (the
  port's attention takes the scores in one batched matmul, the
  reference's per view; LayerNorm's statistics in the library's kernel);
* gradients: each leaf within 1e-4 of its own largest entry, as the zoo's
  tests hold the ResNets' (the backward sums in another order again);
* remat: the recomputed blocks repeat the same ops, so within 1e-6 of
  each leaf's largest entry (the library may pick other kernels);
* the attention op against explicit softmax math: 1e-6 (f32), and in
  bf16 one bf16 ulp of the output's scale (the op rounds once).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.lib.vit_inputs import vit_params  # noqa: E402
from benchmark.reference import vit as ref  # noqa: E402
from benchmark.reference.resnet import (multi_level_ce,  # noqa: E402
                                        scale_images)
from learning_embeddings_tpu_torch.hierarchy import \
    toy_labelmap  # noqa: E402
from learning_embeddings_tpu_torch.models import resnet  # noqa: E402
from learning_embeddings_tpu_torch.models.heads import \
    HierarchicalCNN  # noqa: E402
from learning_embeddings_tpu_torch.models.vit import \
    VisionTransformer  # noqa: E402
from learning_embeddings_tpu_torch.ops import attention as att  # noqa: E402
from learning_embeddings_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from learning_embeddings_tpu_torch.train.classifier import (  # noqa: E402
    ClassifierConfig, ClassifierTrainer)
from learning_embeddings_tpu_torch.utils import profiling  # noqa: E402

torch.set_num_threads(2)

ARCH = ref.Arch(image_size=32, patch=8, depth=2, width=64, heads=4,
                mlp_dim=128)
SMALL = dict(patch=8, depth=2, width=64, heads=4, mlp_dim=128)
LEVELS = (2, 3, 5)
B = 4


@pytest.fixture(autouse=True)
def small_vit(monkeypatch):
    """ViT-L/16's name builds the small ViT; oneDNN off (its bf16 and
    small-shape paths misbehave on some CPUs)."""
    monkeypatch.setitem(resnet.BACKBONES, "vit_l_16", functools.partial(
        VisionTransformer, **SMALL))
    old = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    profiling.clear_spans()
    yield
    torch.backends.mkldnn.enabled = old
    profiling.clear_spans()


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    labels = np.stack([rng.randint(0, n, B) for n in LEVELS], axis=1)
    return images, labels


def _model(remat=False, dtype=torch.float32):
    m = HierarchicalCNN("vit_l_16", LEVELS, dtype=dtype, remat=remat,
                        image_size=32)
    m.load_state_dict(vit_params(5, "cpu", ARCH, sum(LEVELS)))
    return m.train()


def _port_grads(model, images, labels):
    x = scale_images(torch.from_numpy(images))
    logits = model(x)
    loss = multi_level_ce(logits, torch.from_numpy(labels), LEVELS)
    loss.backward()
    return logits.detach(), {k: p.grad for k, p in model.named_parameters()}


def _ref_grads(images, labels):
    p = {k: v.requires_grad_(True) for k, v in
         vit_params(5, "cpu", ARCH, sum(LEVELS)).items()}
    logits = ref.head(p, ref.features(p, scale_images(
        torch.from_numpy(images)), ARCH))
    loss = multi_level_ce(logits, torch.from_numpy(labels), LEVELS)
    names = list(p)
    g = torch.autograd.grad(loss, [p[k] for k in names])
    return logits.detach(), dict(zip(names, g))


def _close_per_leaf(got, want, tol):
    assert set(got) == set(want)
    for k, w in want.items():
        scale = float(w.abs().max())
        err = float((got[k] - w).abs().max())
        assert err <= tol * max(scale, 1e-30), (k, err, scale)


def test_vit_matches_the_reference():
    images, labels = _inputs()
    logits, grads = _port_grads(_model(), images, labels)
    r_logits, r_grads = _ref_grads(images, labels)
    np.testing.assert_allclose(logits.numpy(), r_logits.numpy(), rtol=1e-5,
                               atol=1e-5)
    _close_per_leaf(grads, r_grads, 1e-4)


def test_parameter_names_are_the_references():
    names = [k for k, _ in _model().named_parameters()]
    assert sorted(names) == sorted(ref.shapes(ARCH, sum(LEVELS)))
    assert "trunk.encoder.layers.encoder_layer_1.mlp.3.weight" in names


def test_remat_gives_the_same_gradients():
    images, labels = _inputs(1)
    _, plain = _port_grads(_model(), images, labels)
    _, remat = _port_grads(_model(remat=True), images, labels)
    _close_per_leaf(remat, plain, 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_is_softmax_math(dtype):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 3, 7, 8, generator=g).to(dtype)
               .requires_grad_(True) for _ in range(3))
    out = att.attention(q, k, v)
    assert out.dtype == dtype and out.shape == q.shape
    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    want = torch.softmax(qf @ kf.transpose(-2, -1) / np.sqrt(8), -1) @ vf
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    scale = float(want.detach().abs().max())
    assert float((out.float() - want).abs().max()) <= tol * scale
    dout = torch.randn(2, 3, 7, 8, generator=g)
    out.backward(dout.to(dtype))
    want.backward(dout.to(dtype).float())
    for got, w in ((q, qf), (k, kf), (v, vf)):
        assert got.grad.dtype == dtype
        err = float((got.grad.float() - w.grad).abs().max())
        assert err <= 4 * tol * float(w.grad.abs().max())


def test_attention_without_gradient_builds_no_node():
    q = torch.randn(1, 1, 3, 4)
    want = torch.softmax(q @ q.transpose(-2, -1) * 0.5, -1) @ q
    out = att.attention(q, q, q)
    torch.testing.assert_close(out, want)
    assert out.grad_fn is None


@pytest.mark.parametrize("remat", [False, True])
def test_launches_and_spans_per_block(remat):
    images, labels = _inputs(2)
    model = _model(remat=remat)
    profiling.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        _port_grads(model, images, labels)
    depth = ARCH.depth
    # a forward and a backward a block; remat runs each forward again
    assert profiling.counts()["attention"] == depth * (3 if remat else 2)
    fwd, bwd = (profiling.spans(n) for n in ("attention.fwd",
                                              "attention.bwd"))
    assert len(fwd) == depth * (2 if remat else 1)
    assert len(bwd) == depth
    # each backward span opens after the output's gradient and closes
    # once q, k and v have theirs: spans of one thread, in order
    for s in bwd:
        assert s.t0_ns <= s.t1_ns and s.events is None
    assert len({s.thread for s in bwd}) == 1


def test_no_span_outside_a_profiler_and_launches_still_counted():
    images, labels = _inputs(2)
    profiling.reset_counts()
    _port_grads(_model(), images, labels)
    assert profiling.counts()["attention"] == 2 * ARCH.depth
    assert profiling.spans("attention.fwd") == []
    assert profiling.spans("attention.bwd") == []


def _config(**kw):
    return ClassifierConfig(backbone="vit_l_16", image_size=32, batch_size=B,
                            device="cpu", lr=1e-3, **kw)


def test_spatial_partition_and_mesh_refuse_the_vit():
    lm = toy_labelmap(2, 3)
    with pytest.raises(ValueError, match="spatial_partition"):
        ClassifierTrainer(lm, _config(spatial_partition=True))
    with pytest.raises(ValueError, match="one device"):
        ClassifierTrainer(lm, _config(), mesh=Mesh(2, 1, "cpu"))


def test_trainer_steps_the_vit():
    lm = toy_labelmap(2, 3)
    tr = ClassifierTrainer(lm, _config(dtype=torch.bfloat16))
    assert isinstance(tr.model.trunk, VisionTransformer)
    assert tr.model.trunk.encoder.pos_embedding.shape == (1, 17, 64)
    rng = np.random.RandomState(4)
    images = rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    ll = lm.leaf_paths()[rng.randint(0, lm.levels[-1], B)]
    mh = np.zeros((B, lm.n_classes), np.float32)
    mh[np.arange(B)[:, None], ll + np.asarray(lm.level_start)] = 1.0
    before = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    profiling.reset_counts()
    tr.state, loss = tr.train_step(tr.state, *tr.put_batch(images, ll, mh))
    assert np.isfinite(float(loss))
    assert profiling.counts()["attention"] == 2 * ARCH.depth
    assert profiling.counts()["bn_stats"] == 0
    moved = [k for k, p in tr.model.named_parameters()
             if not torch.equal(p.detach(), before[k])]
    assert "trunk.class_token" in moved and "trunk.encoder.pos_embedding" \
        in moved and "fc.weight" in moved
    loss, scores = tr.eval_step(tr.state, *tr.put_batch(images, ll, mh))
    assert scores.shape == (B, lm.n_classes) and scores.dtype == torch.float32
    assert np.isfinite(float(loss))


def test_init_draws_every_vit_leaf_from_the_seed():
    def start(seed):
        m = HierarchicalCNN("vit_l_16", LEVELS, image_size=32)
        resnet.init_params_(m, torch.Generator().manual_seed(seed))
        return dict(m.named_parameters())
    a, b, c = start(0), start(0), start(1)
    for k in ("trunk.class_token", "trunk.encoder.pos_embedding",
              "trunk.encoder.layers.encoder_layer_0.self_attention."
              "in_proj_weight"):
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
        assert float(a[k].std()) > 0
    assert torch.equal(a["trunk.encoder.ln.weight"], torch.ones(64))


@pytest.mark.parametrize("name", ["alexnet", "vgg11_bn", "resnet18"])
def test_convolutional_trunks_take_and_ignore_image_size(name):
    def shapes(**kw):
        return [(k, v.shape) for k, v in
                resnet.make_trunk(name, **kw).state_dict().items()]
    assert shapes(image_size=32) == shapes(image_size=448) == shapes()


def test_ethec_cli_builds_the_vit(monkeypatch, tmp_path):
    from learning_embeddings_tpu_torch.cli import ethec_experiments as cli

    lm = toy_labelmap(2, 3)
    monkeypatch.setattr(cli, "load_ethec_data",
                        lambda data_dir, debug: (lm, {}, None))
    monkeypatch.setattr(cli, "_run", lambda args, labelmap, datasets, cfg,
                        evaluator: ClassifierTrainer(labelmap, cfg))
    tr = cli.main(["--data_dir", str(tmp_path), "--image_dir",
                   str(tmp_path), "--experiment_dir", str(tmp_path),
                   "--experiment_name", "v", "--model", "vit_l_16",
                   "--loss", "multi_level", "--image_size", "32",
                   "--batch_size", "4", "--n_epochs", "1", "--set_mode",
                   "train", "--device", "cpu"])
    assert isinstance(tr.model.trunk, VisionTransformer)
    assert tr.cfg.backbone == "vit_l_16"
    assert tr.model.trunk.encoder.pos_embedding.shape[1] == 17
