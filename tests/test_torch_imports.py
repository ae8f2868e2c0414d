"""The port and chip_smoke.py import neither JAX nor the JAX package, and
the port imports triton only inside functions (the CUDA path)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "learning_embeddings_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "learning_embeddings_tpu")
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
                "entry.py", "data/butterfly200_taxonomy.json"]:
        assert (PORT / rel).is_file(), rel
    assert (ROOT / "chip_smoke.py").is_file()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, node in _imports(tree):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, (
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
