"""The Swin cell on the CPU at a small size (a Swin of width 16, depths
2/2/2/2, heads 1/2/4/8, window 4, patch 4, at 128², batch 8, in float32,
put in place of Swin-L under its name), with the look for a card
skipped: a sound run comes out correct, each planted fault that the cell
has to catch makes it incorrect (those of a training cell, and the shift
mask or the relative bias left out), and the control (the reference in
fp8) fails the limits; the operation and byte counts against the paper;
the readers of the new metrics.

Limits of this size, as the ViT cell's test sets them: the float32
program against the float32 reference in another summation order
(blocks of 3 images against the batch of 8) reads leaf gaps far under
1e-2; an unchanged state reads 1, and a fault of the attention moves
whole leaves.
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
from benchmark.lib import harness, swin_flops  # noqa: E402
from benchmark.lib.cell_faults import planted  # noqa: E402
from benchmark.reference.swin import Arch, shapes  # noqa: E402
from learning_embeddings_tpu_torch.models import resnet, swin  # noqa: E402

CELL = "swin_l_384_hier_cls.train_b64"
SMALL = dict(image_size=128, patch_size=4, embed_dim=16,
             depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8], window_size=4,
             activations="float32")
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-2, "grad_gap_median": 1e-2,
          "change_gap": 1e-2, "bias_grad_gap": 1e-2}


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """A checkout whose Swin cell runs the small Swin in float32."""
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
    p = root / "benchmark" / "configs" / "swin_l_384_hier_cls.json"
    c = json.loads(p.read_text())
    c.update(SMALL)
    p.write_text(json.dumps(c))
    return str(root)


@pytest.fixture(autouse=True)
def small_swin(monkeypatch):
    monkeypatch.setitem(resnet.BACKBONES, "swin_l", functools.partial(
        swin.SwinTransformer, patch=4, embed_dim=16, depths=(2, 2, 2, 2),
        heads=(1, 2, 4, 8), window=4))
    old = torch.backends.mkldnn.enabled, torch.get_num_threads()
    torch.backends.mkldnn.enabled = False
    torch.set_num_threads(4)
    yield
    torch.backends.mkldnn.enabled = old[0]
    torch.set_num_threads(old[1])


def _run(root, trace=0, seed=2**31 + 29):
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
    assert set(res["metrics"]) == {"mfu.swin"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "no_shift_mask", "no_relative_bias"])
def test_fault_makes_the_run_incorrect(small_root, fault):
    with planted(fault):
        rc, res = _run(small_root)
    assert rc == 0
    assert res["correct"] is False, res["checks"]


def test_control_fails_the_limits(small_root):
    (r,) = calibrate.readings(CELL, controls=[7], device="cpu",
                              root=small_root)
    assert any(r["numbers"][k] > v for k, v in LIMITS.items()), r


def test_swin_counts_match_the_paper():
    # arXiv:2103.14030, Table 1: Swin-L at 384² (window 12) 103.9 G and
    # at 224² (window 7) 34.5 G multiply-adds, 197 M parameters with the
    # 1000-class head
    a = Arch()
    assert swin_flops.swin_macs(a, 1000) == pytest.approx(103.9e9,
                                                          rel=0.005)
    assert swin_flops.swin_macs(Arch(image_size=224, window=7), 1000) == \
        pytest.approx(34.5e9, rel=0.005)
    assert swin_flops.train_flops(a, 344) == 3 * swin_flops.forward_flops(
        a, 344)
    n = sum(torch.Size(s).numel() for k, s in shapes(a, 1000).items())
    assert n == pytest.approx(197e6, rel=0.005)
    trunk = sum(torch.Size(s).numel() for k, s in shapes(a, 1).items()
                if k.startswith("trunk."))
    assert trunk == sum(p.numel() for p in swin.swin_l().parameters())
    assert 194e6 < trunk < 196e6


def test_window_attention_bound_at_swin_l_384_batch_64():
    # bytes bound it: 24·T·C a block and image in bf16 over 3.35 TB/s
    reader = harness.metric("window_attention_roofline.swin")
    a = Arch()
    tc = sum(g * g * c * d for g, c, _, d in a.stages())
    assert swin_flops.attention_train_bytes(a) == 24 * tc
    assert reader.bound_ms(64, a) == pytest.approx(1e3 * 64 * 24 * tc
                                                   / 3.35e12)
    assert round(reader.bound_ms(64, a), 2) == 6.29
    flops_ms = 1e3 * 64 * swin_flops.attention_train_flops(a) / 989e12
    assert round(flops_ms, 2) == 1.53


@pytest.mark.parametrize("name", ["mfu.swin", "window_attention_ms.swin",
                                  "window_attention_roofline.swin",
                                  "window_shuffle_ms.swin"])
def test_new_readers_read_nothing_without_their_inputs(name):
    assert harness.metric(name).read(None, {"host": {}}) is None
