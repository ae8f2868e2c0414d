"""The port's mesh (``parallel/mesh.py``) against the JAX package's on the
CPU: ``param_shardings`` decisions and ``make_mesh`` errors; the
autograd collectives on 2 and 4 gloo ranks; ``pairwise_energy_sharded``
on a (2, 2) mesh against the JAX function on (4, 2) (rtol 3e-5, atol
3e-6, the JAX test's; the order energy's tiles equal the whole matrix bit
for bit); and the ranking and reconstruction metrics with their energies
tiled over (2, 1) and (1, 2) meshes equal to the one-device ones.

The ranks are processes started by ``parallel/launch.py::run_ranks`` (a
FileStore under tmp_path, a time limit, every rank killed when one fails)
running functions of ``parallel/programs.py``; they import no JAX."""

import re
import types

import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

from learning_embeddings_tpu.geometry import (
    pairwise_energy as jax_pairwise, pairwise_energy_sharded as jax_sharded)
from learning_embeddings_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh, param_shardings as jax_param_shardings)
from learning_embeddings_tpu_torch.geometry.pairwise import (
    pairwise_energy, pairwise_energy_sharded)
from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
from learning_embeddings_tpu_torch.models.heads import HierarchicalCNN
from learning_embeddings_tpu_torch.parallel.launch import run_ranks
from learning_embeddings_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, param_shardings)
from learning_embeddings_tpu_torch.parallel.programs import eval_metrics_run

torch.set_num_threads(2)
PROGRAMS = "learning_embeddings_tpu_torch.parallel.programs:"


def ranks(tmp_path, name, world, **kw):
    return run_ranks(PROGRAMS + name, world, kw, workdir=str(tmp_path),
                     threads=1, timeout_s=120)


class _Head(nn.Module):
    def __init__(self, fan_in, fan_out):
        super().__init__()
        self.fc = nn.Linear(fan_in, fan_out)


@pytest.mark.parametrize("fan_in,fan_out,n_model", [
    (512, 39, 2),      # odd fan-out: row-parallel (JAX tests/test_classifier
    (2048, 723, 2),    # .py:75-81), ETHEC's 723
    (2048, 344, 2),    # Butterfly200: column-parallel
    (2048, 344, 4),
    (5, 7, 2),         # neither divides: replicated
    (512, 39, 3)])
def test_param_shardings_match_jax(fan_in, fan_out, n_model):
    jmesh = jax_make_mesh(n_data=8 // n_model, n_model=n_model)
    jtree = {"fc": {"kernel": jnp.zeros((fan_in, fan_out)),
                    "bias": jnp.zeros((fan_out,))}}
    want = jax_param_shardings(jtree, jmesh, ("fc/kernel",))
    got = param_shardings(_Head(fan_in, fan_out),
                          types.SimpleNamespace(shape=dict(jmesh.shape)),
                          ("fc/kernel",))
    for leaf, name in (("kernel", "fc.weight"), ("bias", "fc.bias")):
        spec = tuple(want["fc"][leaf].spec)
        spec = spec + (None,) * (len(got[name].spec) - len(spec))
        assert got[name].spec == spec, (name, got[name], spec)
        assert got[name].jax_path == f"fc/{leaf}"
    # the torch dim of the sharded JAX axis: (in, out) → weight (out, in)
    axis = [i for i, a in enumerate(got["fc.weight"].spec) if a == "model"]
    assert got["fc.weight"].dim == (None if not axis else 1 - axis[0])
    assert got["fc.bias"].dim is None


def test_param_shardings_of_the_classifier_shard_only_the_head():
    model = HierarchicalCNN("resnet18", (3, 9, 27), dtype=torch.float32)
    got = param_shardings(model, types.SimpleNamespace(
        shape={"data": 4, "model": 2}), ("fc/kernel",))
    sharded = {k: v for k, v in got.items() if v.dim is not None}
    assert list(sharded) == ["fc.weight"]            # 39 odd: fan-in 512
    assert sharded["fc.weight"].spec == ("model", None)
    assert got["trunk.layer1.0.conv1.weight"].jax_path == \
        "trunk/layer1_0/conv1/kernel"
    # one rank: nothing shards
    assert all(v.dim is None for v in param_shardings(
        model, types.SimpleNamespace(shape={"data": 8, "model": 1}),
        ("fc/kernel",)).values())


def test_make_mesh_errors_are_the_jax_ones():
    with pytest.raises(ValueError) as jerr:
        jax_make_mesh(n_data=8, n_model=2)
    with pytest.raises(ValueError) as err:
        make_mesh(4, 2, device="cpu")         # no process group: one rank
    pattern = (r"mesh \(\d+ data x \d+ model\) = \d+ devices does not fit "
               r"the \d+ available device\(s\)")
    assert re.fullmatch(pattern, str(jerr.value))
    assert str(err.value) == ("mesh (4 data x 2 model) = 8 devices does "
                              "not fit the 1 available device(s)")
    with pytest.raises(ValueError, match="does not fit"):
        make_mesh(0, 1, device="cpu")
    mesh = make_mesh(device="cpu")            # 1 × 1 without a group
    assert isinstance(mesh, Mesh) and mesh.shape == {"data": 1, "model": 1}
    assert mesh.data_group is None and mesh.model_group is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_mesh(device="cuda")


def test_collectives_forward_and_backward(tmp_path):
    """rank r holds rows of value r + 1; the loss of rank r weighs the
    gathered rows by arange · (r + 1)."""
    res = ranks(tmp_path, "collective_check", 4, n_data=2, n_model=2)
    assert [(r["data_index"], r["model_index"]) for r in res] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    for r in res:
        k, m = r["data_index"], r["model_index"]
        peers = [d * 2 + m for d in range(2)]    # its 'data' group
        want = np.concatenate([np.full((2, 3), p + 1.0) for p in peers])
        for reduce_grad in (True, False):
            y, gx = r[f"gather_{reduce_grad}"]
            np.testing.assert_array_equal(y, want)
            scale = (sum(p + 1.0 for p in peers) if reduce_grad
                     else r["rank"] + 1.0)
            np.testing.assert_array_equal(gx, w[2 * k:2 * k + 2] * scale)
        # identity forward, the gradient summed over the 'model' group
        model_peers = [k * 2 + j for j in range(2)]
        y, gx = r["copy"]
        np.testing.assert_array_equal(y, np.full(3, r["rank"] + 1.0))
        np.testing.assert_array_equal(
            gx, np.full(3, sum(p + 1.0 for p in model_peers)))
        # sum forward, identity backward
        y, gx = r["reduce"]
        np.testing.assert_array_equal(
            y, np.full(3, sum(p + 1.0 for p in model_peers)))
        np.testing.assert_array_equal(gx, np.full(3, 2.0))
        np.testing.assert_array_equal(r["bools"],
                                      [p % 2 == 0 for p in peers])


@pytest.mark.parametrize("kind", ["order", "euc_cone", "hyp_cone"])
def test_pairwise_energy_sharded_matches_jax(kind, tmp_path):
    rng = np.random.RandomState(0)
    u = rng.randn(23, 10).astype(np.float32) * 0.3   # 23 % 2 != 0
    v = rng.randn(37, 10).astype(np.float32) * 0.3   # 37 % 2 != 0
    kw = {"K": 0.2} if kind == "hyp_cone" else {}
    jmesh = jax_make_mesh(n_data=4, n_model=2)
    want = np.asarray(jax_pairwise(kind, u, v, **kw))
    np.testing.assert_allclose(
        np.asarray(jax_sharded(kind, u, v, mesh=jmesh, **kw)), want,
        rtol=3e-5, atol=3e-6)
    res = ranks(tmp_path, "pairwise_tiles", 4, n_data=2, n_model=2,
                kind=kind, u=u, v=v, **kw)
    single = pairwise_energy(kind, torch.from_numpy(u), torch.from_numpy(v),
                             **kw).numpy()
    for r in res:
        assert r["E"].shape == (23, 37)
        np.testing.assert_allclose(r["E"], want, rtol=3e-5, atol=3e-6)
        np.testing.assert_array_equal(r["E"], res[0]["E"])
        if kind == "order":    # each entry as on one device: bit for bit
            np.testing.assert_array_equal(r["E"], single)
        assert r["counts"]["collective_pairwise_tiles"] == 2
    # empty input and mesh=None take the plain function, bit for bit
    t_u, t_v = torch.from_numpy(u), torch.from_numpy(v)
    mesh = make_mesh(device="cpu")
    assert pairwise_energy_sharded(kind, t_u, t_v[:0], mesh=mesh,
                                   **kw).shape == (23, 0)
    np.testing.assert_array_equal(
        single, pairwise_energy_sharded(kind, t_u, t_v, mesh=None,
                                        **kw).numpy())
    np.testing.assert_array_equal(
        single, pairwise_energy_sharded(kind, t_u, t_v, mesh=mesh,
                                        **kw).numpy())


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (1, 2)])
def test_ranking_and_reconstruction_meshed_equal_one_device(
        n_data, n_model, tmp_path):
    """As JAX tests/test_geometry.py:349-375: sharding the energies
    changes no ranking or threshold decision."""
    lm = toy_labelmap(3, 3)
    rng = np.random.RandomState(1)
    n_img = 13
    label_emb = rng.randn(lm.n_classes, 6).astype(np.float32) * 0.3
    img_emb = rng.randn(n_img, 6).astype(np.float32) * 0.3
    paths = lm.leaf_paths()[rng.randint(0, lm.levels[-1], n_img)]
    paths_global = paths + np.asarray(lm.level_start)[None, :]
    closure = np.zeros((lm.n_classes, lm.n_classes), bool)
    closure[np.triu_indices(lm.n_classes, 1)] = True
    args = dict(labelmap=lm, label_emb=label_emb, img_emb=img_emb,
                paths_global=paths_global, closure=closure,
                energy="hyp_cone", K=0.2)
    want = eval_metrics_run(**args)
    res = ranks(tmp_path, "eval_metrics", n_data * n_model, n_data=n_data,
                n_model=n_model, **args)
    for r in res:
        np.testing.assert_array_equal(r["ranking"].pop("top1_per_level"),
                                      want["ranking"]["top1_per_level"])
        for k, v in r["ranking"].items():
            assert v == pytest.approx(want["ranking"][k], rel=1e-6), k
        for k, v in r["reconstruction"].items():
            assert v == pytest.approx(want["reconstruction"][k],
                                      rel=1e-6, abs=1e-6), k
