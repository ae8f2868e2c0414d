"""CPU checks of the benchmark's own pieces: what it imports, its counts
of operations and bytes, and that cells and metrics are found by name."""

import ast
import json
import os
import shutil
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from benchmark.lib import flops, harness  # noqa: E402

#: no file of the benchmark may import these (whole top-level names)
NEVER = {"jax", "jaxlib", "flax", "learning_embeddings_tpu"}
#: nor may the reference import the measured package
PROGRAM = "learning_embeddings_tpu_torch"


def _imports(path):
    """Top-level names of every module `path` imports (absolute imports;
    relative ones stay inside the benchmark)."""
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(sub=""):
    top = os.path.join(BENCH, sub)
    return [os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs
            if f.endswith(".py")]


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = _imports(path) & NEVER
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert PROGRAM not in _imports(path), path
        assert not (_imports(path) & NEVER), path


def test_top_level_names_are_compared_whole():
    # the port's name begins with the JAX package's: neither a prefix
    # match nor the port itself may count as the JAX package
    assert PROGRAM.startswith("learning_embeddings_tpu")
    assert PROGRAM not in NEVER
    sys.path.insert(0, BENCH)
    import run
    assert "learning_embeddings_tpu" in run.FORBIDDEN
    assert PROGRAM.split(".")[0] not in run.FORBIDDEN


def test_resnet50_multiply_adds_match_torchvision():
    # torchvision's published 4.09 GFLOPS (multiply-adds) at 224², 1000
    # classes
    assert flops.resnet50_macs(224, 1000) == pytest.approx(4.09e9, rel=0.01)
    assert flops.train_flops(448, 344) == 3 * flops.forward_flops(448, 344)


def test_bn_byte_bound_reproduces_the_kernel_table():
    # chip_smoke.py::bound_ms over ResNet-50@448's 53 shapes at batch 128:
    # K1 3.397 ms, K2 6.795 ms
    reader = harness.metric("bn_kernels_roofline.train")
    k1, k2 = reader.step_bound_s(128, 448)
    assert round(1e3 * k1, 3) == 3.397
    assert round(1e3 * k2, 3) == 6.795
    assert len(flops.bn_shapes(448)) == 53


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    root = _copy(tmp_path)
    before = {p: open(p, "rb").read() for p in
              (str(f) for f in root.rglob("*") if f.is_file())}
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = "resnet50_448_hier_cls.train_b64"
    spec["workloads"].append({"name": cell, "config": "resnet50_448_hier_cls",
                              "traffic": "train_b64", "chips": 1,
                              "why": "half the batch"})
    spec["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "model step",
                              "moves": "train_images_per_s",
                              "workloads": [cell]})
    spec["end_to_end"][0]["workloads"].append(cell)
    work = json.loads((root / "benchmark" / "workloads" /
                       "resnet50_448_hier_cls.train_b128.json").read_text())
    work.update(name=cell, traffic="train_b64")
    work["params"]["batch"] = 64
    (root / "benchmark" / "workloads" / f"{cell}.json").write_text(
        json.dumps(work))
    (root / "benchmark" / "metrics" / "steps_seen.train.py").write_text(
        "def read(window, info):\n    return info.get('steps')\n")
    # the listing is the only existing file that changes
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    assert cell in harness.cells(str(root))
    w, conf = harness.cell(cell, str(root))
    assert w["params"]["batch"] == 64
    assert conf["name"] == "resnet50_448_hier_cls"
    e2e, per_layer = harness.cell_metrics(cell, str(root))
    assert [m["name"] for m in e2e] == ["train_images_per_s", "setup_s"]
    assert [m["name"] for m in per_layer] == ["steps_seen.train"]
    assert harness.metric("steps_seen.train", str(root)).read(
        None, {"steps": 7}) == 7
    assert harness.driver(w["driver"], str(root)).unit == "images"
    after = {str(f): f.read_bytes() for f in root.rglob("*") if f.is_file()}
    changed = [p for p in before if after[p] != before[p]]
    assert changed == [str(root / "BENCHMARK.json")]


def test_every_listed_piece_exists_and_reads():
    spec = harness.spec()
    for w in spec["workloads"]:
        work, conf = harness.cell(w["name"])
        assert work["config"] == w["config"] == conf["name"]
        assert work["traffic"] == w["traffic"]
        assert work["why"] == w["why"]
        harness.driver(work["driver"])
    for m in spec["per_layer"]:
        assert callable(harness.metric(m["name"]).read)
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_trace_window_counts_busy_time_once():
    from benchmark.lib.trace import Window
    ops = [("k1", 0.0, 100.0), ("Memcpy HtoD", 50.0, 150.0),
           ("k2", 300.0, 400.0)]
    host = [("aten::conv", 140.0, 320.0), ("step", 0.0, 1000.0)]
    w = Window(ops, host, window_s=1e-3)
    assert w.busy_s == pytest.approx(250e-6)       # [0, 150] ∪ [300, 400]
    assert w.seconds_by(lambda n: n.startswith("k")) == pytest.approx(2e-4)
    # the 150 µs gap is named after the innermost host range around it
    assert w.idle_gaps() == [("aten::conv", pytest.approx(150e-6))]
    b = w.breakdown()
    assert [n for n, _ in b["device_ops"]] == ["k", "Memcpy HtoD"]


def test_idle_share_never_reads_zero_busy():
    from benchmark.lib.trace import Window
    reader = harness.metric("device_idle.train")
    assert reader.read(Window([], [], 1.0), {}) is None
    assert reader.read(Window([("k", 0.0, 2.5e5)], [], 1.0), {}) == \
        pytest.approx(75.0)


def test_vector_gap_reads_direction():
    from benchmark.lib.check import vector_gap
    r = torch.tensor([[1.0, -2.0], [0.5, 0.0]])
    w = torch.tensor([[1.0, 2.0], [1.0, 0.0]])
    assert vector_gap(r.clone(), r, w) == 0.0
    assert vector_gap(torch.zeros_like(r), r, w) == pytest.approx(1.0)
    assert vector_gap(-r, r, w) == pytest.approx(2.0)
    # an entry of no weight (no gradient in the reference) is left out
    assert vector_gap(r + torch.tensor([[0.0, 0.0], [0.0, 9.0]]), r, w) \
        == 0.0
