"""Whole runs of each cell on the CPU at a small size, with the look for
a card skipped: a sound run comes out correct, and each fault the check
has to catch (``lib/faults.py``) makes it come out not correct. The
cells run in float32 here, where the program and the reference agree to
rounding; the limits are this size's own (ResNet-50 at 64², batch 8, is
ill-conditioned: float32 and float64 references differ by up to 1.6e-4
in the loss and 1.3e-2 in a leaf's norm).
"""

import io
import json
import os
import shutil
import subprocess
import sys
import types
from contextlib import redirect_stdout

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from benchmark import calibrate, run  # noqa: E402
from benchmark.lib.faults import planted  # noqa: E402

TRAIN = "resnet50_448_hier_cls.train_b128"
EVAL = "resnet50_448_hier_cls.eval_b128"
JOINT = "resnet50_448_hypcone_joint.train_e16"

SMALL = {
    TRAIN: ({"batch": 8, "pool_batches": 4},
            {"loss_gap": 5e-3, "grad_gap": 0.1, "change_gap": 0.2}),
    EVAL: ({"batch": 8, "split_rows": 20, "pool_batches": 2},
           {"score_gap": 1e-4}),
    JOINT: ({"batch": 16, "epoch_edges": 32, "bank_images": 64,
             "warm_rows": [16, 32, 48]},
            {"loss_gap": 0.05, "grad_gap": 0.1, "change_gap": 0.3,
             "label_change_gap": 0.3, "edges_mismatch": 0}),
}


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """A checkout whose cells run at 64² in float32."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for cell, (params, limits) in SMALL.items():
        p = root / "benchmark" / "workloads" / f"{cell}.json"
        w = json.loads(p.read_text())
        w["params"].update(params)
        w["check"] = limits
        p.write_text(json.dumps(w))
    for conf in ("resnet50_448_hier_cls", "resnet50_448_hypcone_joint"):
        p = root / "benchmark" / "configs" / f"{conf}.json"
        c = json.loads(p.read_text())
        c.update(image_size=64, activations="float32")
        if "graph_images" in c:
            c["graph_images"] = 400
        p.write_text(json.dumps(c))
    return str(root)


@pytest.fixture(autouse=True)
def cpu_threads():
    # oneDNN's bf16 and small-shape paths misbehave on this CPU; few
    # threads keep the runs light
    old = torch.backends.mkldnn.enabled, torch.get_num_threads()
    torch.backends.mkldnn.enabled = False
    torch.set_num_threads(4)
    yield
    torch.backends.mkldnn.enabled = old[0]
    torch.set_num_threads(old[1])


def _run(root, cell, trace=0, seed=2**31 + 17):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", "0.2", "--trace", str(trace)],
                      device="cpu", root=root)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.mark.parametrize("cell", [TRAIN, EVAL, JOINT])
def test_sound_run_is_correct(small_root, cell):
    rc, res = _run(small_root, cell)
    assert rc == 0
    assert res["correct"] is True, res["checks"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2


@pytest.mark.parametrize("cell,metrics", [
    (TRAIN, {"mfu.train"}), (EVAL, {"mfu.eval"}),
    (JOINT, {"host_prep_ms.joint", "mfu.joint"})])
def test_traced_run_reports_per_layer_metrics(small_root, cell, metrics):
    # on the CPU no operation runs on a card: the readers of device
    # time read nothing and leave their metrics out
    rc, res = _run(small_root, cell, trace=1)
    assert rc == 0 and res["correct"] is True
    assert set(res["metrics"]) == metrics
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell,fault", [
    (TRAIN, "unchanged"), (TRAIN, "half_batch"), (EVAL, "altered"),
    (JOINT, "unchanged"), (JOINT, "half_batch")])
def test_fault_makes_the_run_incorrect(small_root, cell, fault):
    with planted(fault):
        rc, res = _run(small_root, cell)
    assert rc == 0
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", [TRAIN, EVAL, JOINT])
def test_control_fails_the_limits(small_root, cell):
    """The reference in fp8 in the program's place fails a number."""
    (r,) = calibrate.readings(cell, controls=[5], device="cpu",
                              root=small_root)
    limits = SMALL[cell][1]
    assert any(r["numbers"][k] > v for k, v in limits.items()), r


def test_forbidden_module_stops_the_run(small_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, res = _run(small_root, EVAL)
    assert rc != 0 and res is None


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", EVAL,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
