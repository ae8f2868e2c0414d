"""The ViT cell on the CPU at a small size (a 2-block ViT of width 64, 4
heads, patch 8, at 32², batch 8, in float32, put in place of ViT-L/16
under its name), with the look for a card skipped: a sound run comes out
correct, each planted fault that a training cell has to catch makes it
incorrect, and the control (the reference in fp8) fails the limits; the
operation counts against torchvision's; the readers of the new metrics.

Limits of this size: the float32 program against the float32 reference
in another summation order (blocks of 3 images against the batch of 8)
reads a loss gap of ~3e-8, leaf gaps of ~5e-7 and a change gap of ~2e-3
(Adam divides each entry's step by its gradient's root mean square), so
1e-4 and 1e-2 leave room; an unchanged state reads 1 and half a batch
0.09-1.2 on the leaf gaps.
"""

import functools
import io
import json
import os
import shutil
import sys
from contextlib import redirect_stdout

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from benchmark import calibrate, run  # noqa: E402
from benchmark.lib import harness, vit_flops  # noqa: E402
from benchmark.lib.faults import planted  # noqa: E402
from benchmark.reference.vit import Arch  # noqa: E402
from learning_embeddings_tpu_torch.models import resnet  # noqa: E402
from learning_embeddings_tpu_torch.models.vit import \
    VisionTransformer  # noqa: E402

CELL = "vit_l16_448_hier_cls.train_b64"
SMALL = dict(image_size=32, patch_size=8, num_hidden_layers=2,
             hidden_size=64, intermediate_size=128, num_attention_heads=4,
             activations="float32")
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-2, "grad_gap_median": 1e-2,
          "change_gap": 1e-2}


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """A checkout whose ViT cell runs the small ViT in float32."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    p = root / "benchmark" / "workloads" / f"{CELL}.json"
    w = json.loads(p.read_text())
    w["params"].update(batch=8, pool_batches=4, ref_block=3,
                       warmup_seconds=0.05)
    w["check"] = LIMITS
    p.write_text(json.dumps(w))
    p = root / "benchmark" / "configs" / "vit_l16_448_hier_cls.json"
    c = json.loads(p.read_text())
    c.update(SMALL)
    p.write_text(json.dumps(c))
    return str(root)


@pytest.fixture(autouse=True)
def small_vit(monkeypatch):
    monkeypatch.setitem(resnet.BACKBONES, "vit_l_16", functools.partial(
        VisionTransformer, patch=8, depth=2, width=64, heads=4, mlp_dim=128))
    old = torch.backends.mkldnn.enabled, torch.get_num_threads()
    torch.backends.mkldnn.enabled = False
    torch.set_num_threads(4)
    yield
    torch.backends.mkldnn.enabled = old[0]
    torch.set_num_threads(old[1])


def _run(root, trace=0, seed=2**31 + 23):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", CELL, "--seed", str(seed),
                       "--seconds", "0.2", "--trace", str(trace)],
                      device="cpu", root=root)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def test_sound_run_is_correct(small_root):
    rc, res = _run(small_root)
    assert rc == 0
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_images_per_s", "setup_s"}


def test_traced_run_reports_the_host_clock_metric(small_root):
    # on the CPU no span has an event pair and no op runs on a card: the
    # readers of device time read nothing and leave their metrics out
    rc, res = _run(small_root, trace=1)
    assert rc == 0 and res["correct"] is True
    assert set(res["metrics"]) == {"mfu.vit"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_fault_makes_the_run_incorrect(small_root, fault):
    with planted(fault):
        rc, res = _run(small_root)
    assert rc == 0
    assert res["correct"] is False, res["checks"]


def test_control_fails_the_limits(small_root):
    (r,) = calibrate.readings(CELL, controls=[7], device="cpu",
                              root=small_root)
    assert any(r["numbers"][k] > v for k, v in LIMITS.items()), r


def test_vit_multiply_adds_match_torchvision():
    # torchvision's published 61.55 GFLOPS (multiply-adds) for vit_l_16 at
    # 224², 1000 classes
    assert vit_flops.vit_macs(Arch(image_size=224), 1000) == \
        pytest.approx(61.55e9, rel=0.01)
    a = Arch()
    assert a.tokens == 785
    assert vit_flops.train_flops(a, 344) == 3 * vit_flops.forward_flops(
        a, 344)


def test_attention_bound_at_vit_l16_448_batch_64():
    # 3 × 4·B·N²·D·L over 989 TFLOP/s at B 64, N 785, D 1024, L 24
    reader = harness.metric("attention_roofline.vit")
    assert reader.bound_ms(64, Arch()) == pytest.approx(
        1e3 * 3 * 4 * 64 * 785 ** 2 * 1024 * 24 / 989e12)
    assert round(reader.bound_ms(64, Arch()), 2) == 11.76


def test_new_readers_read_nothing_without_their_inputs():
    for name in ("mfu.vit", "attention_ms.vit", "attention_roofline.vit"):
        assert harness.metric(name).read(None, {"host": {}}) is None
