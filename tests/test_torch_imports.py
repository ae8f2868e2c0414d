"""The port, chip_smoke.py, k3_variants.py and onednn_dw_repro.py import
neither JAX nor the JAX package, the port imports triton only inside functions (the CUDA path), and its CPU path
never builds or loads the CUDA kernel library. The port needs no sklearn
(its PR curves and AP are numpy) except for drawing a t-SNE
(``viz/tsne.py::render_tsne`` imports it when it runs)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "learning_embeddings_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "learning_embeddings_tpu")
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                     ROOT / "k3_variants.py",
                                     ROOT / "onednn_dw_repro.py"]


def _imports(tree):
    """(module name, node) for every absolute import under `tree`; the
    port's relative imports stay inside the port."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, node


def test_port_has_the_slice_modules():
    for rel in ["__init__.py", "hierarchy/labelmap.py", "ops/image.py",
                "ops/bn.py", "ops/bn_triton.py", "models/resnet.py",
                "models/heads.py", "models/jax_import.py",
                "losses/classification.py", "train/classifier.py",
                "entry.py", "data/butterfly200_taxonomy.json",
                # slice 2
                "hierarchy/graph.py", "geometry/energies.py",
                "csrc/pairwise_order.cu", "ops/pairwise_order.py",
                "geometry/pairwise.py", "models/embedder.py",
                "losses/margin.py", "losses/joint_sampling.py",
                "eval/threshold.py", "eval/metrics.py", "eval/ranking.py",
                "eval/reconstruction.py", "data/pipeline.py",
                "train/joint.py", "train/joint_cnn.py",
                # slice 4
                "geometry/poincare.py", "optim/__init__.py",
                "optim/rsgd.py", "train/embedding.py",
                # slice 5
                "data/records.py", "train/experiment.py", "train/runner.py",
                "viz/toy.py", "cli/__init__.py", "cli/common.py",
                "cli/order_embeddings.py", "cli/order_embeddings_h.py",
                "cli/embed_toy.py", "cli/validate_embedding.py",
                "cli/_joint_main.py", "cli/oe.py", "cli/oe_h.py",
                # slice 6
                "eval/multilabel.py", "eval/reports.py",
                "data/sampling.py", "utils/__init__.py",
                "utils/profiling.py", "viz/contours.py",
                "cli/ethec_experiments.py", "cli/image_emb.py",
                # slice 7
                "viz/hypernymy.py",
                # slice 8
                "viz/lime.py", "viz/tsne.py", "eval/confusion.py",
                "utils/tblog.py", "hierarchy/stats.py", "data/workloads.py",
                "cli/inference.py", "cli/post_process.py",
                "cli/convert_tblog.py", "cli/fashion_mnist.py",
                "cli/cifar.py",
                # slice 9
                "csrc/le_loader.cc", "csrc/Makefile",
                "data/native_loader.py", "data/preprocess.py",
                "data/build_db.py", "cli/debug_launchers.py"]:
        assert (PORT / rel).is_file(), rel
    assert (ROOT / "chip_smoke.py").is_file()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, node in _imports(tree):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, (
            f"{path.name}:{node.lineno} imports {name}")


#: the one module that may import sklearn, inside the function that draws
SKLEARN_ONLY_INSIDE = {PORT / "viz" / "tsne.py": "render_tsne"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_sklearn_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    allowed = SKLEARN_ONLY_INSIDE.get(path)
    inside = set()
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == allowed:
            inside = {id(n) for n in ast.walk(node)}
    for name, node in _imports(tree):
        assert name.split(".")[0] != "sklearn" or id(node) in inside, (
            f"{path.name}:{node.lineno} imports {name}")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_triton_only_imported_inside_functions(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:   # statements that run at import time
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for name, imp in _imports(node):
            assert name.split(".")[0] != "triton", (
                f"{path.name}:{imp.lineno} imports triton at import time")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_optional_libraries_only_imported_inside_functions(path):
    """cv2, PIL and matplotlib (absent on some machines) and tensorboard
    (slow to import) load only where a function needs them."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for name, imp in _imports(node):
            assert name.split(".")[0] not in ("cv2", "PIL", "matplotlib") \
                and not name.startswith("torch.utils.tensorboard"), (
                    f"{path.name}:{imp.lineno} imports {name} at import "
                    "time")


def test_native_loader_builds_from_the_port_alone():
    """The port's JPEG loader compiles its own copy of the source into the
    checkout's .torch_kernels, never the JAX package's native/."""
    from learning_embeddings_tpu_torch.data import native_loader
    assert pathlib.Path(native_loader._CSRC) == PORT / "csrc"
    assert pathlib.Path(native_loader._LIB_PATH).parent == \
        ROOT / ".torch_kernels" / "native"
    rules = [line for line in (PORT / "csrc" / "Makefile").read_text()
             .splitlines() if not line.startswith("#")]
    assert any("le_loader.cc" in line for line in rules)
    assert not any("/native" in line.replace(".torch_kernels/native", "")
                   for line in rules)


def test_cpu_path_never_builds_or_loads_the_cuda_library(monkeypatch):
    """The order-energy wrapper on CPU tensors runs the plain version: no
    nvcc, no ctypes load, no launch counted."""
    import torch

    from learning_embeddings_tpu_torch.geometry import pairwise_energy
    from learning_embeddings_tpu_torch.ops import pairwise_order as k3

    def refuse(*a, **k):
        raise AssertionError("the CPU path tried to build or load the "
                             "CUDA library")

    monkeypatch.setattr(k3, "build_library", refuse)
    monkeypatch.setattr(k3, "_library", refuse)
    monkeypatch.setattr(k3.subprocess, "run", refuse)
    before = k3.LAUNCHES
    u = torch.randn(7, 10)
    out = pairwise_energy("order", u, torch.randn(9, 10))
    assert out.shape == (7, 9) and k3._LIB is None
    assert k3.LAUNCHES == before



def test_plot_modules_import_no_matplotlib():
    """Importing the plot modules (and the runners and CLIs that use them)
    loads no matplotlib and no sklearn: the card's machine has neither,
    and only a plot needs them."""
    import subprocess
    import sys

    code = ("import sys; "
            "import learning_embeddings_tpu_torch.viz.contours, "
            "learning_embeddings_tpu_torch.viz.hypernymy, "
            "learning_embeddings_tpu_torch.viz.toy, "
            "learning_embeddings_tpu_torch.train.runner, "
            "learning_embeddings_tpu_torch.cli.oe_h, "
            "learning_embeddings_tpu_torch.viz.lime, "
            "learning_embeddings_tpu_torch.viz.tsne, "
            "learning_embeddings_tpu_torch.eval.confusion, "
            "learning_embeddings_tpu_torch.utils.tblog, "
            "learning_embeddings_tpu_torch.hierarchy.stats, "
            "learning_embeddings_tpu_torch.cli.inference, "
            "learning_embeddings_tpu_torch.cli.post_process, "
            "learning_embeddings_tpu_torch.cli.convert_tblog, "
            "learning_embeddings_tpu_torch.cli.fashion_mnist, "
            "learning_embeddings_tpu_torch.cli.cifar; "
            "assert 'matplotlib' not in sys.modules, 'matplotlib loaded'; "
            "assert 'sklearn' not in sys.modules, 'sklearn loaded'; "
            "assert 'tensorboard' not in sys.modules, 'tensorboard loaded'")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=300)
