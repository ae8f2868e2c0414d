"""Spatial partitioning (``parallel/spatial.py``; the trunks of
``models/resnet.py``; ``ClassifierConfig.spatial_partition``) on the CPU,
float32, against the unsharded computation:

* ``halo_rows`` for every conv and pool window of the model zoo, and the
  plan (which units run H-sharded, where the activation is gathered) of
  the shapes the tests and the card run;
* each halo-exchanged op (the convs of every window in the zoo, the s2d
  stem's conv, the max-pools) on 2 and 4 gloo ranks equals the unsharded
  op: output, input gradient and weight gradient within atol 1e-6; the
  gather of H and the global mean pool likewise;
* the classifier step on a (1, 2) mesh against the port's one-device
  step: ResNet-50@64 (Bottleneck, downsample, every layer H-sharded) with
  each BatchNorm route (pallas, ghost, flax), the s2d stem, AlexNet and
  VGG11BN (each gathered where its rows stop splitting), remat,
  grad_accum=2, one SGD step each: the loss and the eval step's loss and
  scores within 1e-5, the head's kernel within rtol 1e-4 / atol 1e-6,
  the running statistics bit-equal on both ranks and within 1e-5 of each
  tensor's largest entry of one device's (1e-4 for ResNet-50: float32
  ResNet-50's deep statistics cancel, and a data-parallel mesh's differ
  from one device's by up to 5.1e-5 there too, batch 4 at 64²), the halo
  exchanges as many as ``spatial_halo_counts`` predicts; one SGD step of
  ResNet-18@48 (a stride-2 block whose rank-1 block would start at an odd
  row, so it is gathered there) moves every trunk weight as one device
  does, sharded and replicated layers alike;
* with no mesh, or one model rank, the field changes nothing: the steps
  are bit-equal to those without it.

The JAX (2, 4) oracle is ``tests/test_torch_spatial_jax.py``; the CLI
under ranks ``tests/test_torch_spatial_cli.py``."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
from learning_embeddings_tpu_torch.models.resnet import (make_trunk,
                                                         spatial_halo_counts)
from learning_embeddings_tpu_torch.parallel.launch import run_ranks
from learning_embeddings_tpu_torch.parallel.programs import (
    classifier_run, synthetic_batches)
from learning_embeddings_tpu_torch.parallel.spatial import (Window,
                                                            halo_rows, plan)
from learning_embeddings_tpu_torch.train.classifier import (
    ClassifierConfig, ClassifierTrainer)

torch.set_num_threads(2)
PROGRAMS = "learning_embeddings_tpu_torch.parallel.programs:"


# ----------------------------------------------------------------------
# halo rows and the plan
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kernel,stride,pad,want", [
    (7, 2, 3, (3, 2)),      # the ResNet stem
    (3, 1, 1, (1, 1)),      # a 3×3/s1 conv
    (3, 2, 1, (1, 0)),      # a 3×3/s2 conv, and the ResNet max-pool
    (4, 1, 2, (2, 1)),      # the s2d stem's 4×4/s1 after its (2, 1) pad
    (11, 4, 5, (5, 2)),     # AlexNet's first conv
    (5, 1, 2, (2, 2)),      # AlexNet's second conv
    (3, 2, 0, (0, 1)),      # AlexNet's unpadded pools
    (2, 2, 0, (0, 0)),      # VGG's pools
    (1, 1, 0, (0, 0)),      # a bottleneck's 1×1 convs
    (1, 2, 0, (0, 0)),      # a 1×1/s2 downsample
])
def test_halo_rows(kernel, stride, pad, want):
    assert halo_rows(kernel, stride, pad) == want


def _plan(backbone, size, parts, **kw):
    trunk = make_trunk(backbone, dtype=torch.float32, **kw)
    units = trunk.spatial_units()
    return plan([c for _, _, c in units], size // parts, parts)


@pytest.mark.parametrize("backbone,size,parts,kw,n_sharded,n_units", [
    # the JAX test's ResNet-18@32 on 4 model shards: layer2 leaves one
    # row a rank, layer3's stride-2 block gathers
    ("resnet18", 32, 4, {}, 6, 10),
    # every layer H-sharded: the card's cell and the CPU's Bottleneck case
    ("resnet50", 448, 2, {}, 18, 18),
    ("resnet50", 64, 2, {}, 18, 18),
    ("resnet18", 64, 2, dict(stem="s2d"), 10, 10),
    # layer3's stride-2 block would start rank 1 at row 3: gathered
    ("resnet18", 48, 2, {}, 6, 10),
    # AlexNet's unpadded 3×3/s2 pool never splits evenly (H/2 − 1 rows)
    ("alexnet", 64, 2, {}, 1, 8),
    ("vgg11_bn", 64, 2, {}, 13, 13),
    ("vgg11_bn", 32, 2, {}, 12, 13),
])
def test_plan_shards_while_the_rows_split(backbone, size, parts, kw,
                                          n_sharded, n_units):
    on = _plan(backbone, size, parts, **kw)
    assert len(on) == n_units
    assert on == [True] * n_sharded + [False] * (n_units - n_sharded)


def test_window_fits_only_aligned_even_splits():
    w = Window(3, 2, 1, 1)
    assert w.fits(4, 2) and w.fits(2, 4)
    assert not w.fits(3, 2)          # a block would start at an odd row
    assert not Window(3, 2, 0, 0).fits(8, 2)   # H/2 − 1 output rows
    assert not Window(7, 2, 3, 3).fits(2, 4)   # a halo of 3 from 2 rows


def test_halo_counts_of_the_card_cell():
    """ResNet-50@448 on two model ranks: the stem, the pool and the 16
    3×3 convs exchange in the forward pass, all but the stem (whose input
    is the image) in the backward pass; remat exchanges again for each
    recomputed block."""
    trunk = make_trunk("resnet50", dtype=torch.float32)
    assert spatial_halo_counts(trunk, 448, 2) == {"halo": 18,
                                                  "halo_grad": 17}
    assert spatial_halo_counts(trunk, 448, 2, remat=True) == {
        "halo": 34, "halo_grad": 17}


# ----------------------------------------------------------------------
# the ops on 2 and 4 ranks
# ----------------------------------------------------------------------
OPS = {"conv7_s2": ("conv", 7, 2, 3), "conv3_s1": ("conv", 3, 1, 1),
       "conv3_s2": ("conv", 3, 2, 1), "conv11_s4": ("conv", 11, 4, 5),
       "conv5_s1": ("conv", 5, 1, 2), "conv1_s2": ("conv", 1, 2, 0),
       "s2d_conv4": ("s2d_conv",), "pool3_s2": ("pool", 3, 2, 1),
       "pool2_s2": ("pool", 2, 2, 0), "gather": ("gather",),
       "mean": ("mean",)}
SHAPE = (2, 3, 32, 12)


@pytest.fixture(scope="module", params=[2, 4])
def op_runs(request, tmp_path_factory):
    parts = request.param
    res = run_ranks(PROGRAMS + "spatial_ops", parts,
                    dict(n_model=parts, specs=list(OPS.values()),
                         shape=SHAPE), threads=1, timeout_s=120,
                    workdir=str(tmp_path_factory.mktemp(f"ops{parts}")))
    return parts, res


def _whole_op(spec, i):
    """The unsharded op on the inputs ``spatial_ops`` draws."""
    rng = np.random.RandomState(i)
    x = torch.tensor((0.1 * rng.randn(*SHAPE)).astype(np.float32),
                     requires_grad=True)
    w = None
    kind = spec[0]
    if kind in ("conv", "s2d_conv"):
        k = spec[1] if kind == "conv" else 4
        C = SHAPE[1]
        w = torch.tensor((rng.randn(5, C, k, k) / np.sqrt(C * k * k))
                         .astype(np.float32), requires_grad=True)
        y = (F.conv2d(x, w, None, spec[2], spec[3]) if kind == "conv"
             else F.conv2d(F.pad(x, (2, 1, 2, 1)), w))
    elif kind == "pool":
        y = F.max_pool2d(x, spec[1], spec[2], spec[3])
    elif kind == "gather":
        y = x * 1
    else:
        y = x.mean(dim=(2, 3))
    g = (0.1 * rng.randn(*y.shape)).astype(np.float32)
    (y * torch.tensor(g)).sum().backward()
    return (y.detach().numpy(), x.grad.numpy(),
            None if w is None else w.grad.numpy())


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_on_ranks_equals_the_unsharded_op(op_runs, name):
    parts, res = op_runs
    i = list(OPS).index(name)
    spec = OPS[name]
    y, dx, dw = _whole_op(spec, i)
    mine = [r[i] for r in res]
    whole = spec[0] in ("gather", "mean")
    got_y = (mine[0]["y"] if whole
             else np.concatenate([m["y"] for m in mine], axis=2))
    if whole:
        for m in mine:
            np.testing.assert_array_equal(m["y"], mine[0]["y"])
    got_dx = np.concatenate([m["dx"] for m in mine], axis=2)
    np.testing.assert_allclose(got_y, y, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_dx, dx, rtol=0, atol=1e-6)
    if dw is not None:
        np.testing.assert_allclose(sum(m["dw"] for m in mine), dw, rtol=0,
                                   atol=1e-6)
    for m in mine:
        assert m["channels_last"], name
        c = m["counts"]
        halo = spec[0] in ("conv", "s2d_conv", "pool") and halo_rows(
            *(spec[1:] if spec[0] != "s2d_conv" else (4, 1, 2))) != (0, 0)
        assert c.get("collective_halo", 0) == int(halo)
        assert c.get("collective_halo_grad", 0) == int(halo)
        assert c.get("collective_gather_height", 0) == int(
            spec[0] == "gather")
    if spec[0] == "pool":
        # the −inf edge takes no gradient: every gradient lands on x
        np.testing.assert_allclose(got_dx.sum(), dx.sum(), atol=1e-6)


# ----------------------------------------------------------------------
# the classifier step on (1, 2)
# ----------------------------------------------------------------------
B = 4
LM = toy_labelmap(3, 3)
#: ResNet-50 at batch 8 (its float32 loss differs by up to 1.4e-5 between
#: summation orders at batch 4)
R50 = dict(batch_size=8)
CASES = {
    "resnet50_pallas": ("resnet50", 64, R50),
    "resnet50_ghost": ("resnet50", 64, dict(bn_stats_rows=6, **R50)),
    "resnet50_flax": ("resnet50", 64, dict(bn_impl="flax", **R50)),
    "resnet18_s2d": ("resnet18", 64, dict(stem="s2d")),
    "alexnet": ("alexnet", 64, {}),
    "vgg11_bn": ("vgg11_bn", 32, {}),
    "resnet18_remat": ("resnet18", 48, dict(remat=True)),
    "resnet18_grad_accum": ("resnet18", 64, dict(grad_accum=2)),
}
#: one SGD step at lr 1: the trunk's weights move by minus their gradient
GRAD_CASE = ("resnet18", 48, dict(optimizer="sgd", lr=1.0))
GRAD_KEYS = ("trunk.conv1.weight", "trunk.bn1.weight",
             "trunk.layer1.0.conv2.weight", "trunk.layer2.1.bn2.bias",
             "trunk.layer2.1.conv2.weight",       # sharded at odd offsets
             "trunk.layer3.0.conv1.weight",       # gathered
             "trunk.layer3.0.downsample.0.weight",
             "trunk.layer4.1.conv2.weight", "trunk.layer4.1.bn2.weight")


def _cfg(backbone, size, kw):
    # SGD: Adam's first step moves a weight whose gradient is at rounding
    # level by ±lr, whichever side it rounds to
    return ClassifierConfig(**{**dict(
        backbone=backbone, criterion="multi_level_ce", lr=1e-2,
        optimizer="sgd", image_size=size, batch_size=B, dtype=torch.float32,
        device="cpu", spatial_partition=True), **kw})


def _case(backbone, size, kw, state_keys=("fc.weight",)):
    n = 2 if kw.get("grad_accum") else 1
    cfg = _cfg(backbone, size, kw)
    return dict(labelmap=LM, cfg=cfg, synthetic=(n, 0),
                state_keys=state_keys, eval_batch=synthetic_batches(
                    LM, 1, cfg.batch_size, size, 1)[0])


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    cases = [_case(*v) for v in CASES.values()]
    cases.append(_case(*GRAD_CASE, state_keys=GRAD_KEYS))
    one = [classifier_run(**kw) for kw in cases]
    res = run_ranks(PROGRAMS + "classifier_cases", 2,
                    dict(n_data=1, n_model=2, cases=cases),
                    workdir=str(tmp_path_factory.mktemp("steps")),
                    threads=1, timeout_s=300)
    return cases, one, res


@pytest.mark.parametrize("name", sorted(CASES))
def test_spatial_step_equals_one_device(step_runs, name):
    cases, one, res = step_runs
    i = list(CASES).index(name)
    ref, kw = one[i], cases[i]
    scale = np.abs(ref["eval_scores"]).max()
    for r in (rank[i] for rank in res):
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["eval_loss"], ref["eval_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(r["eval_scores"], ref["eval_scores"],
                                   rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(r["state_dict"]["fc.weight"],
                                   ref["state_dict"]["fc.weight"],
                                   rtol=1e-4, atol=1e-6)
        tol = 1e-4 if kw["cfg"].backbone == "resnet50" else 1e-5
        for k, v in r["running"].items():
            np.testing.assert_array_equal(v, res[0][i]["running"][k])
            np.testing.assert_allclose(
                v, ref["running"][k], rtol=0,
                atol=tol * np.abs(ref["running"][k]).max(), err_msg=k)
        cfg = kw["cfg"]
        trunk = make_trunk(cfg.backbone, dtype=cfg.dtype, stem=cfg.stem)
        want = spatial_halo_counts(trunk, cfg.image_size, 2,
                                   remat=cfg.remat)
        steps = len(r["losses"])
        c = r["counts"]
        assert c.get("collective_halo", 0) == want["halo"] * steps
        assert c.get("collective_halo_grad", 0) == want["halo_grad"] * steps
        assert c["collective_grads_model"] == 1     # one update


def test_spatial_gradients_equal_one_device(step_runs):
    """One SGD step at lr 1 from the same start: each weight moves by its
    gradient, held to one device's within 1e-3 of its largest entry (two
    summation orders differ by ~1e-4 here, as they do on a data-parallel
    mesh). The stem and layer2 run H-sharded, layer3's first block and
    everything after it replicated."""
    cases, one, res = step_runs
    ref = one[-1]["state_dict"]
    start = ClassifierTrainer(LM, cases[-1]["cfg"]).model.state_dict()
    for r in (rank[-1] for rank in res):
        for k in GRAD_KEYS:
            want = start[k].numpy() - ref[k]
            got = start[k].numpy() - r["state_dict"][k]
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-3 * np.abs(want).max(),
                                       err_msg=k)
    assert res[0][-1]["counts"]["collective_gather_height"] == 1


# ----------------------------------------------------------------------
# the field without a model axis
# ----------------------------------------------------------------------
def _two_steps(cfg, batches):
    tr = ClassifierTrainer(LM, cfg)
    losses = [float(tr.train_step(tr.state, *tr.put_batch(*b))[1])
              for b in batches]
    return losses, {k: v.clone() for k, v in tr.model.state_dict().items()}


def test_without_a_mesh_the_field_changes_nothing():
    cfg = _cfg("resnet18", 32, {})
    batches = synthetic_batches(LM, 2, B, 32, 0)
    got = _two_steps(cfg, batches)
    want = _two_steps(dataclasses.replace(cfg, spatial_partition=False),
                      batches)
    assert got[0] == want[0]
    for k, v in want[1].items():
        assert torch.equal(got[1][k], v), k


def test_with_one_model_rank_the_field_changes_nothing(tmp_path):
    """JAX's P("data", "model") is data sharding on a (2, 1) mesh."""
    cfg = _cfg("resnet18", 32, {})
    cases = [dict(labelmap=LM, cfg=c, synthetic=(1, 0),
                  state_keys=("fc.weight", "trunk.layer1.0.conv1.weight"))
             for c in (cfg, dataclasses.replace(cfg,
                                                spatial_partition=False))]
    res = run_ranks(PROGRAMS + "classifier_cases", 2,
                    dict(n_data=2, n_model=1, cases=cases),
                    workdir=str(tmp_path), threads=1, timeout_s=120)
    for on, off in res:
        assert on["losses"] == off["losses"]
        for k in off["state_dict"]:
            np.testing.assert_array_equal(on["state_dict"][k],
                                          off["state_dict"][k])
        for k in off["running"]:
            np.testing.assert_array_equal(on["running"][k],
                                          off["running"][k])
        assert "collective_halo" not in on["counts"]
