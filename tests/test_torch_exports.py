"""Every name a JAX module exports (its ``__all__``) is exported by the
port's module at the same path, except the differences kept by design,
which are listed here by name; and every name a port module exports
resolves. A JAX caller's import then works against the port.

The JAX side is read with ``ast`` (no JAX module is imported here); the
port's modules are imported."""

import ast
import importlib
import os

import pytest

import learning_embeddings_tpu

JAX_ROOT = os.path.dirname(learning_embeddings_tpu.__file__)

#: JAX modules whose port lives at another path
MOVED = {"ops/bn_pallas.py": "ops/bn.py"}   # + ops/bn_triton.py (kernels)
#: JAX modules the port has no counterpart of, and why
ABSENT = {
    # the port's ResNets carry torchvision's parameter names, so a
    # torchvision state dict loads as it is (load_backbone_state_dict)
    "models/torch_import.py",
}
#: names a JAX module exports that its port does not, by design
KEPT_BY_DESIGN = {
    # the Pallas BatchNorm module is FusedBatchNorm (K1/K2 in Triton)
    "ops/__init__.py": {"PallasBatchNorm"},
    "ops/bn_pallas.py": {"PallasBatchNorm"},
    # optax gradient transforms; the port has torch optimizers
    # (RiemannianSGD, RiemannianAdam, project_annulus_,
    # scale_by_conformal_factor_)
    "optim/rsgd.py": {"project_annulus_tree", "riemannian_adam",
                      "riemannian_sgd", "scale_by_conformal_factor"},
    # jax.sharding objects; the port's are shard_rows / all_gather_rows
    "parallel/mesh.py": {"batch_sharding", "replicated"},
    # the JAX pipeline falls back to Python when the library is missing;
    # the port's native loader raises instead, so nothing asks
    "data/native_loader.py": {"available"},
}


def _static_all(path):
    """A module's literal ``__all__`` (None without one)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    return None


def _jax_modules():
    out = []
    for root, _, files in os.walk(JAX_ROOT):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                if _static_all(path) is not None:
                    out.append(os.path.relpath(path, JAX_ROOT))
    return sorted(out)


JAX_MODULES = _jax_modules()


def _port_module(rel):
    rel = MOVED.get(rel, rel)
    name = rel[:-3].replace(os.sep, ".")
    if name.endswith("__init__"):
        name = name[:-len(".__init__")]
    return importlib.import_module("learning_embeddings_tpu_torch." + name)


def test_the_walk_finds_the_exporting_modules():
    assert len(JAX_MODULES) >= 20
    for rel in ("eval/__init__.py", "data/__init__.py", "models/resnet.py"):
        assert rel in JAX_MODULES
    assert set(KEPT_BY_DESIGN) | ABSENT | set(MOVED) <= set(JAX_MODULES)


@pytest.mark.parametrize("rel", [m for m in JAX_MODULES if m not in ABSENT])
def test_port_exports_what_jax_exports(rel):
    want = _static_all(os.path.join(JAX_ROOT, rel))
    port = _port_module(rel)
    got = set(port.__all__)
    kept = KEPT_BY_DESIGN.get(rel, set())
    assert kept <= want, (rel, kept - want)
    assert not kept & got, (rel, "listed as kept by design but exported",
                            kept & got)
    assert want - kept <= got, (rel, sorted(want - kept - got))
    for name in got:
        assert hasattr(port, name), (rel, name)


def test_the_queue_c_exports_resolve():
    from learning_embeddings_tpu_torch.data import (augment_eval,
                                                    augment_train,
                                                    decode_image)
    from learning_embeddings_tpu_torch.eval import (
        Summarize, multilabel_metrics, per_class_pr,
        tune_per_class_thresholds, tune_single_threshold)
    from learning_embeddings_tpu_torch.models.resnet import GhostBatchNorm
    from learning_embeddings_tpu_torch.ops.bn import (
        GhostBatchNorm as ghost)

    assert GhostBatchNorm is ghost
    for f in (augment_eval, augment_train, decode_image, Summarize,
              multilabel_metrics, per_class_pr, tune_per_class_thresholds,
              tune_single_threshold):
        assert callable(f)
