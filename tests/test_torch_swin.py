"""The port's Swin trunk (``models/swin.py``) and the biased attention
(``ops/attention.py``) on the CPU, held against the benchmark's plain
reference (``benchmark/reference/swin.py``: the one copy, which imports
nothing of the port and builds the shift, the mask and the relative
index from the paper's equations) at a small size that keeps every kind
of block: patch 4, width 16, depths 2/2/2/2, heads 1/2/4/8 (16 a head),
window 4, 128² images (grids 32, 16, 8, 4: a W-MSA and an SW-MSA block
in each of the first three stages, one window and no shift in the last),
batch 2, float32, seeded random weights (``benchmark/lib/swin_inputs.py``).

Tolerances, each for a reason:
* logits rtol/atol 1e-5: the same f32 arithmetic in another order (the
  port's attention takes the windows folded into the heads in one batched
  matmul, the reference's per window; LayerNorm's statistics in the
  library's kernel);
* gradients: each leaf within 1e-4 of its own largest entry, as the ViT's
  tests hold theirs (the backward sums in another order again; the bias
  tables' gradient sums every window's pairs);
* remat: the recomputed blocks repeat the same ops, so within 1e-6 of
  each leaf's largest entry;
* the biased attention against explicit softmax math: 1e-6 (f32), and in
  bf16 one bf16 ulp of the output's scale (the op rounds once); the bias
  in bf16 is the same bf16 tensor on both sides.
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

from benchmark.lib.swin_inputs import swin_params  # noqa: E402
from benchmark.reference import swin as ref  # noqa: E402
from benchmark.reference.resnet import (multi_level_ce,  # noqa: E402
                                        scale_images)
from learning_embeddings_tpu_torch.hierarchy import \
    toy_labelmap  # noqa: E402
from learning_embeddings_tpu_torch.models import resnet  # noqa: E402
from learning_embeddings_tpu_torch.models import swin  # noqa: E402
from learning_embeddings_tpu_torch.models.heads import \
    HierarchicalCNN  # noqa: E402
from learning_embeddings_tpu_torch.ops import attention as att  # noqa: E402
from learning_embeddings_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from learning_embeddings_tpu_torch.train.classifier import (  # noqa: E402
    ClassifierConfig, ClassifierTrainer)
from learning_embeddings_tpu_torch.utils import profiling  # noqa: E402

torch.set_num_threads(2)

ARCH = ref.Arch(image_size=128, patch=4, embed_dim=16, depths=(2, 2, 2, 2),
                heads=(1, 2, 4, 8), window=4, mlp_ratio=4)
SMALL = dict(patch=4, embed_dim=16, depths=(2, 2, 2, 2), heads=(1, 2, 4, 8),
             window=4, mlp_ratio=4)
LEVELS = (2, 3, 5)
B = 2
S = ARCH.image_size
BLOCKS = sum(ARCH.depths)


@pytest.fixture(autouse=True)
def small_swin(monkeypatch):
    """Swin-L's name builds the small Swin; oneDNN off (its bf16 and
    small-shape paths misbehave on some CPUs)."""
    monkeypatch.setitem(resnet.BACKBONES, "swin_l", functools.partial(
        swin.SwinTransformer, **SMALL))
    old = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    profiling.clear_spans()
    yield
    torch.backends.mkldnn.enabled = old
    profiling.clear_spans()


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (B, S, S, 3)).astype(np.uint8)
    labels = np.stack([rng.randint(0, n, B) for n in LEVELS], axis=1)
    return images, labels


def _model(remat=False, dtype=torch.float32):
    m = HierarchicalCNN("swin_l", LEVELS, dtype=dtype, remat=remat,
                        image_size=S)
    m.load_state_dict(swin_params(5, "cpu", ARCH, sum(LEVELS)))
    return m.train()


def _port_grads(model, images, labels):
    x = scale_images(torch.from_numpy(images))
    logits = model(x)
    loss = multi_level_ce(logits, torch.from_numpy(labels), LEVELS)
    loss.backward()
    return logits.detach(), {k: p.grad for k, p in model.named_parameters()}


def _ref_grads(images, labels):
    p = {k: v.requires_grad_(True) for k, v in
         swin_params(5, "cpu", ARCH, sum(LEVELS)).items()}
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


def test_swin_matches_the_reference():
    images, labels = _inputs()
    logits, grads = _port_grads(_model(), images, labels)
    r_logits, r_grads = _ref_grads(images, labels)
    np.testing.assert_allclose(logits.numpy(), r_logits.numpy(), rtol=1e-5,
                               atol=1e-5)
    _close_per_leaf(grads, r_grads, 1e-4)
    # every bias table takes a gradient
    tables = [k for k in grads if k.endswith("relative_position_bias_table")]
    assert len(tables) == BLOCKS
    assert all(float(grads[k].abs().max()) > 0 for k in tables)


def test_remat_gives_the_same_gradients():
    images, labels = _inputs(1)
    _, plain = _port_grads(_model(), images, labels)
    _, remat = _port_grads(_model(remat=True), images, labels)
    _close_per_leaf(remat, plain, 1e-6)


def _blocks(model):
    return [b for layer in model.trunk.features[1:]
            if not isinstance(layer, swin.PatchMerging) for b in layer]


def _geometry_windows():
    # a grid of 8 tokens a side in windows of 4, shifted by 2: the shift
    # is a brute-force gather of the stream
    G, M, s, C = 8, 4, 2, 3
    x = torch.randn(2, G, G, C, generator=torch.Generator().manual_seed(0))
    win = swin.windows(x, M, s)
    n = G // M
    for w in range(n * n):
        wy, wx = divmod(w, n)
        for t in range(M * M):
            i, j = divmod(t, M)
            assert torch.equal(win[:, w, t], x[:, (wy * M + i + s) % G,
                                                (wx * M + j + s) % G])
    assert torch.equal(swin.unwindows(win, G, M, s), x)


def _geometry_mask():
    # each token's attention weights are zero outside its region of the
    # shifted grid, and not inside it (brute force over every pair)
    model = _model()
    for blk in _blocks(model):
        if not blk.shift:
            assert blk.attn_mask is None
            continue
        G, M, s = blk.grid, blk.window, blk.shift
        N, n = M * M, G // M
        h = torch.randn(1, G, G, blk.norm1.normalized_shape[0],
                        generator=torch.Generator().manual_seed(G))
        win = swin.windows(h, M, s)
        a = blk.attn
        qkv = a.qkv(win).view(1, n * n, N, 3, a.heads, -1)
        q, k = qkv[..., 0, :, :], qkv[..., 1, :, :]
        scores = torch.einsum("bwnhd,bwmhd->bwhnm", q, k) \
            / np.sqrt(q.shape[-1])
        weights = torch.softmax(scores + a.bias(blk.attn_mask, n * n).view(
            1, n * n, a.heads, N, N), -1).detach()

        def part(c):
            return 0 if c < G - M else (1 if c < G - s else 2)
        for w in range(n * n):
            wy, wx = divmod(w, n)
            region = [(part(wy * M + i), part(wx * M + j))
                      for i in range(M) for j in range(M)]
            for t in range(N):
                for u in range(N):
                    p = weights[0, w, :, t, u]
                    if region[t] != region[u]:
                        assert float(p.max()) < 1e-30, (G, w, t, u)
                    else:
                        assert float(p.min()) > 1e-30, (G, w, t, u)


def _geometry_relative_index():
    # the paper's formula: (yi − yj + M − 1)·(2M − 1) + (xi − xj + M − 1)
    for M in (2, 4, 7, 12):
        idx = swin.relative_position_index(M).view(M * M, M * M)
        for i in range(M * M):
            for j in range(M * M):
                (yi, xi), (yj, xj) = divmod(i, M), divmod(j, M)
                assert int(idx[i, j]) == (yi - yj + M - 1) * (2 * M - 1) \
                    + (xi - xj + M - 1)
        assert int(idx.max()) == (2 * M - 1) ** 2 - 1
        assert np.array_equal(idx.numpy(), ref.relative_index(M))


def _geometry_mask_is_the_references():
    for G, M, s in ((32, 4, 2), (16, 4, 2), (8, 4, 2), (96, 12, 6)):
        assert np.array_equal(swin.shift_mask(G, M, s).numpy(),
                              ref.region_mask(G, M, s))


def _geometry_parameter_names():
    names = [k for k, _ in _model().named_parameters()]
    assert names == list(ref.shapes(ARCH, sum(LEVELS)))
    for k in ("trunk.features.0.0.weight", "trunk.features.0.2.bias",
              "trunk.features.3.1.attn.relative_position_bias_table",
              "trunk.features.4.reduction.weight",
              "trunk.features.7.1.mlp.3.weight", "trunk.norm.weight"):
        assert k in names
    assert "trunk.features.4.reduction.bias" not in names


@pytest.mark.parametrize("check", [
    _geometry_windows, _geometry_mask, _geometry_relative_index,
    _geometry_mask_is_the_references, _geometry_parameter_names],
    ids=["windows", "mask", "relative_index", "mask_is_the_references",
         "parameter_names"])
def test_geometry(check):
    check()


def test_published_shapes():
    # Swin-L at 384²: ~195 M trunk parameters (197 M with the paper's
    # 1000-class head), the last stage one window and no shift
    trunk = swin.swin_l(image_size=384)
    n = sum(p.numel() for p in trunk.parameters())
    assert n == sum(int(np.prod(s)) for k, s in ref.shapes(
        ref.Arch(), 1).items() if k.startswith("trunk."))
    assert 194e6 < n < 196e6 and 196e6 < n + 1536 * 1000 + 1000 < 198e6
    assert trunk.feature_dim == 1536
    blocks = [b for layer in trunk.features[1:]
              if not isinstance(layer, swin.PatchMerging) for b in layer]
    assert [b.shift for b in blocks] == [0, 6] * 11 + [0, 0]
    assert [b.grid for b in blocks] == [96] * 2 + [48] * 2 + [24] * 18 \
        + [12] * 2
    with pytest.raises(ValueError, match="multiple of the window"):
        swin.swin_l(image_size=224)


def _attention_case(dtype, bias_shape):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 3, 7, 8, generator=g).to(dtype)
               .requires_grad_(True) for _ in range(3))
    bias = torch.randn(bias_shape, generator=g).to(dtype).requires_grad_(
        True)
    out = att.attention(q, k, v, bias)
    assert out.dtype == dtype and out.shape == q.shape
    qf, kf, vf, bf = (t.detach().float().requires_grad_(True)
                      for t in (q, k, v, bias))
    want = torch.softmax(qf @ kf.transpose(-2, -1) / np.sqrt(8) + bf,
                         -1) @ vf
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    scale = float(want.detach().abs().max())
    assert float((out.float() - want).abs().max()) <= tol * scale
    dout = torch.randn(2, 3, 7, 8, generator=g)
    out.backward(dout.to(dtype))
    want.backward(dout.to(dtype).float())
    for got, w in ((q, qf), (k, kf), (v, vf), (bias, bf)):
        assert got.grad.dtype == dtype and got.grad.shape == got.shape
        err = float((got.grad.float() - w.grad).abs().max())
        assert err <= 4 * tol * float(w.grad.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_shape", [(1, 3, 7, 7), (2, 3, 7, 7)],
                         ids=["broadcast", "full"])
def test_biased_attention_is_softmax_math(dtype, bias_shape):
    _attention_case(dtype, bias_shape)


def test_biased_attention_counts_and_refuses_another_dtype():
    q = torch.randn(1, 2, 3, 4, requires_grad=True)
    bias = torch.zeros(1, 2, 3, 3)
    profiling.reset_counts()
    out = att.attention(q, q, q, bias)
    out.sum().backward()
    c = profiling.counts()
    # a bias that takes no gradient is passed on as it is
    assert (c["attention"], c["attention_bias"]) == (2, 2)
    assert bias.grad is None
    with pytest.raises(ValueError, match="dtype"):
        att.attention(q, q, q, bias.to(torch.bfloat16))


def _old_window_path(qkv, bias, heads):
    # the block's attention before the window attention op: q, k, v
    # unpacked, the biased call, the output transposed back
    B, nW, N, C3 = qkv.shape
    d = C3 // 3 // heads
    q, k, v = qkv.view(B, nW, N, 3, heads, d).permute(
        3, 0, 1, 4, 2, 5).reshape(3, B, nW * heads, N, d).unbind(0)
    y = att.attention(q, k, v, bias)
    return y.view(B, nW, heads, N, d).transpose(2, 3).reshape(
        B, nW, N, C3 // 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 2], ids=["w_msa", "sw_msa"])
def test_window_attention_plain_route_is_the_old_path(dtype, shift):
    # grid 8, window 4, 2 heads of 8: the output and the qkv and bias
    # gradients bit for bit, since the plain route runs the same ops
    from learning_embeddings_tpu_torch.ops import window_attention as wa

    G, M, heads, C, Bi = 8, 4, 2, 16, 3
    gen = torch.Generator().manual_seed(shift)
    a = swin.ShiftedWindowAttention(C, heads, M)
    with torch.no_grad():
        a.relative_position_bias_table.normal_(0, 0.5, generator=gen)
    mask = swin.shift_mask(G, M, shift) if shift else None
    x = torch.randn(Bi, (G // M) ** 2, M * M, C, generator=gen)
    dout = torch.randn(Bi, (G // M) ** 2, M * M, C, generator=gen).to(dtype)
    got = []
    for fn in (wa.window_attention, _old_window_path):
        a.zero_grad()
        qkv = a.qkv(x).to(dtype).detach().requires_grad_(True)
        bias = a.bias(mask, (G // M) ** 2).to(dtype)
        out = fn(qkv, bias, heads)
        out.backward(dout)
        got.append((out.detach(), qkv.grad,
                    a.relative_position_bias_table.grad.clone()))
    for new, old in zip(*got):
        assert new.dtype == old.dtype and torch.equal(new, old)
    assert float(got[0][2].abs().max()) > 0


@pytest.mark.parametrize("pairs, plan", [(384, (64, 1)), (192, (32, 2)),
                                         (96, (16, 4)), (48, (13, 5))],
                         ids=["stage1", "stage2", "stage3", "stage4"])
def test_window_attention_launch_plan(pairs, plan):
    # Swin-L's stages at B 64 on 132 one-block SMs: each grid of pairs ×
    # chunks ends in the fewest waves of (2 + chunk) image times, and the
    # chunks cover the batch
    from learning_embeddings_tpu_torch.ops import window_attention as wa

    assert wa.launch_plan(64, pairs, 132) == plan
    chunk, n = plan
    assert (n - 1) * chunk < 64 <= n * chunk
    # one image, or one slot, still plans
    assert wa.launch_plan(1, pairs, 132) == (1, 1)
    assert wa.launch_plan(5, 3, 1) == (5, 1)


@pytest.mark.parametrize("fault", ["no_shift_mask", "no_relative_bias"])
def test_cell_faults_reach_the_window_attention(fault):
    # each fault the benchmark plants in ShiftedWindowAttention.bias still
    # changes what the new path computes: the tables' gradients (the shift
    # mask cuts pairs across regions; no relative bias, no gradient)
    from benchmark.lib import cell_faults

    images, labels = _inputs(3)
    logits, grads = _port_grads(_model(), images, labels)
    with cell_faults.planted(fault):
        f_logits, f_grads = _port_grads(_model(), images, labels)
    tables = [k for k in grads if k.endswith("relative_position_bias_table")]
    assert len(tables) == BLOCKS
    assert not torch.equal(logits, f_logits)
    if fault == "no_relative_bias":
        assert all(f_grads[k] is None for k in tables)
        return
    shifted = [k for k in tables if grads[k] is not None and not torch.equal(
        grads[k], f_grads[k])]
    # the shifted blocks, one in each of the first three stages
    assert len(shifted) >= 3


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("profiled", [False, True])
def test_counts_and_spans_per_step(remat, profiled):
    images, labels = _inputs(2)
    model = _model(remat=remat)
    profiling.reset_counts()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            _port_grads(model, images, labels)
    else:
        _port_grads(model, images, labels)
    # a forward and a backward a block; remat runs each forward again
    per = 3 if remat else 2
    c = profiling.counts()
    assert c["attention"] == c["attention_bias"] == BLOCKS * per
    # the kernel pair runs on a card alone
    assert c["window_attention"] == 0
    # the windows and their reverse, each forward and backward
    assert c["swin_windows"] == 2 * BLOCKS * per
    names = ("attention.fwd", "attention.bwd", "swin.windows",
             "swin.windows.bwd")
    got = [len(profiling.spans(n)) for n in names]
    fwd = 2 if remat else 1
    if not profiled:
        assert got == [0, 0, 0, 0]
        return
    assert got == [BLOCKS * fwd, BLOCKS, 2 * BLOCKS * fwd, 2 * BLOCKS]
    for n in names[1::2]:
        spans = profiling.spans(n)
        assert all(s.t0_ns <= s.t1_ns and s.events is None for s in spans)
        assert len({s.thread for s in spans}) == 1


def _config(**kw):
    return ClassifierConfig(backbone="swin_l", image_size=S, batch_size=B,
                            device="cpu", lr=1e-3, **kw)


@pytest.mark.parametrize("kw, match", [
    (dict(cfg=dict(spatial_partition=True)), "spatial_partition"),
    (dict(mesh=True), "one device")], ids=["spatial_partition", "mesh"])
def test_swin_refuses(kw, match):
    lm = toy_labelmap(2, 3)
    mesh = Mesh(2, 1, "cpu") if kw.get("mesh") else None
    with pytest.raises(ValueError, match=match):
        ClassifierTrainer(lm, _config(**kw.get("cfg", {})), mesh=mesh)


def test_trainer_steps_the_swin():
    lm = toy_labelmap(2, 3)
    tr = ClassifierTrainer(lm, _config(dtype=torch.bfloat16))
    assert isinstance(tr.model.trunk, swin.SwinTransformer)
    rng = np.random.RandomState(4)
    images = rng.randint(0, 256, (B, S, S, 3)).astype(np.uint8)
    ll = lm.leaf_paths()[rng.randint(0, lm.levels[-1], B)]
    mh = np.zeros((B, lm.n_classes), np.float32)
    mh[np.arange(B)[:, None], ll + np.asarray(lm.level_start)] = 1.0
    before = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    profiling.reset_counts()
    tr.state, loss = tr.train_step(tr.state, *tr.put_batch(images, ll, mh))
    assert np.isfinite(float(loss))
    c = profiling.counts()
    assert c["attention_bias"] == 2 * BLOCKS and c["bn_stats"] == 0
    moved = [k for k, p in tr.model.named_parameters()
             if not torch.equal(p.detach(), before[k])]
    assert "trunk.features.1.1.attn.relative_position_bias_table" in moved
    assert "trunk.features.6.reduction.weight" in moved
    assert "fc.weight" in moved
    loss, scores = tr.eval_step(tr.state, *tr.put_batch(images, ll, mh))
    assert scores.shape == (B, lm.n_classes) and scores.dtype == torch.float32
    assert np.isfinite(float(loss))


def test_init_draws_every_swin_leaf_from_the_seed():
    def start(seed):
        m = HierarchicalCNN("swin_l", LEVELS, image_size=S)
        resnet.init_params_(m, torch.Generator().manual_seed(seed))
        return dict(m.named_parameters())
    a, b, c = start(0), start(0), start(1)
    for k, t in a.items():
        assert torch.equal(t, b[k]), k
        if t.dim() > 1:
            # every weight and bias table is drawn, and from the seed
            assert not torch.equal(t, c[k]) and float(t.std()) > 0, k
    table = a["trunk.features.5.0.attn.relative_position_bias_table"]
    assert 0 < float(table.abs().max()) <= 0.04
    assert torch.equal(a["trunk.norm.weight"], torch.ones(128))
    assert torch.equal(a["trunk.features.1.0.attn.qkv.bias"],
                       torch.zeros(48))


def test_ethec_cli_builds_the_swin(monkeypatch, tmp_path):
    from learning_embeddings_tpu_torch.cli import ethec_experiments as cli

    lm = toy_labelmap(2, 3)
    monkeypatch.setattr(cli, "load_ethec_data",
                        lambda data_dir, debug: (lm, {}, None))
    monkeypatch.setattr(cli, "_run", lambda args, labelmap, datasets, cfg,
                        evaluator: ClassifierTrainer(labelmap, cfg))
    tr = cli.main(["--data_dir", str(tmp_path), "--image_dir",
                   str(tmp_path), "--experiment_dir", str(tmp_path),
                   "--experiment_name", "s", "--model", "swin_l",
                   "--loss", "multi_level", "--image_size", str(S),
                   "--batch_size", "2", "--n_epochs", "1", "--set_mode",
                   "train", "--device", "cpu"])
    assert isinstance(tr.model.trunk, swin.SwinTransformer)
    assert tr.cfg.backbone == "swin_l"
    assert tr.model.trunk.feature_dim == 128
