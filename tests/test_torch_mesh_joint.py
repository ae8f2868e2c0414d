"""The label-only and fc7 joint trainers on a (2, 1) mesh of 2 gloo ranks
on the CPU: every rank draws the global batch's negatives from the same
generator and keeps its block of the edges, the gradients are summed
over 'data' (the losses are sums). Held against the port's own one-device
run (the same draws: the epoch's losses and energies within rtol 1e-5,
the tables within 1e-5) and, for the fc7 eval embeddings of a ragged row
count, against the JAX package's meshed FeatNet (rtol 1e-5, atol 1e-6:
JAX ``tests/test_joint.py:383``). A batch that does not divide over the
data shards raises, as in the JAX trainers. The label-only CLI runs under
``torchrun``, starting its process group from the environment."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from learning_embeddings_tpu.hierarchy import toy_labelmap as jax_toy
from learning_embeddings_tpu.losses.joint_sampling import (
    build_joint_graph as jax_build)
from learning_embeddings_tpu.parallel.mesh import make_mesh as jax_make_mesh
from learning_embeddings_tpu.train.joint import (
    JointEmbeddingTrainer as JaxJoint, JointTrainerConfig as JaxJointConfig)
from learning_embeddings_tpu_torch.hierarchy import (
    label_graph_from_paths, split_edges, toy_labelmap)
from learning_embeddings_tpu_torch.losses.joint_sampling import (
    build_joint_graph)
from learning_embeddings_tpu_torch.models import (
    feat_net_from_jax, label_table_from_jax)
from learning_embeddings_tpu_torch.parallel.launch import run_ranks
from learning_embeddings_tpu_torch.parallel.mesh import Mesh
from learning_embeddings_tpu_torch.parallel.programs import (
    embedding_run, fc7_run)
from learning_embeddings_tpu_torch.train.embedding import (
    EmbeddingTrainer, EmbeddingTrainerConfig)
from learning_embeddings_tpu_torch.train.joint import (
    JointEmbeddingTrainer, JointTrainerConfig)
from learning_embeddings_tpu_torch.train.joint_cnn import (
    JointCNNConfig, JointCNNTrainer)

torch.set_num_threads(2)
PROGRAMS = "learning_embeddings_tpu_torch.parallel.programs:"


def _stats_close(a, b):
    for k in ("loss", "e_pos_mean", "e_neg_mean"):
        assert a[k] == pytest.approx(b[k], rel=1e-5), k


@pytest.mark.parametrize("energy,optimizer", [("hyp_cone", "rsgd"),
                                              ("order", "adam")])
def test_label_only_epochs_on_a_mesh_equal_one_device(energy, optimizer,
                                                      tmp_path):
    lm = toy_labelmap(3, 3)
    splits = split_edges(label_graph_from_paths(lm.leaf_paths(), lm),
                         seed=0)
    cfg = EmbeddingTrainerConfig(energy=energy, embedding_dim=4, lr=1e-2,
                                 optimizer=optimizer, batch_size=8,
                                 neg_to_pos_ratio=2, device="cpu")
    one = embedding_run(lm, splits, cfg, epochs=2)
    res = run_ranks(PROGRAMS + "embedding_epochs", 2,
                    dict(n_data=2, labelmap=lm, splits=splits, cfg=cfg,
                         epochs=2), workdir=str(tmp_path), threads=1,
                    timeout_s=120)
    for r in res:
        for a, b in zip(r["stats"], one["stats"]):
            _stats_close(a, b)
        np.testing.assert_allclose(r["table"]["embedding"],
                                   one["table"]["embedding"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(r["table"]["embedding"],
                                      res[0]["table"]["embedding"])
        for k in ("val_f1", "test_f1", "reconstruction_f1"):
            assert r[k] == pytest.approx(one[k], abs=1e-6), k
        # the gradients: one all-reduce a step; the reconstruction's tiles
        assert r["counts"]["collective_grads"] == len(splits.train) // 8 * 2
        assert r["counts"]["collective_pairwise_tiles"] == 1


@pytest.fixture(scope="module")
def fc7():
    lm, jlm = toy_labelmap(2, 3), jax_toy(2, 3)
    rng = np.random.RandomState(0)
    ll = lm.leaf_paths()[rng.randint(0, lm.levels[-1], 24)]
    graph, edges = build_joint_graph(lm, ll)
    jgraph, _ = jax_build(jlm, ll)
    feats = rng.randn(24, 32).astype(np.float32)
    eval_feats = rng.randn(11, 32).astype(np.float32)    # 11: ragged
    eval_paths = (lm.leaf_paths()[rng.randint(0, lm.levels[-1], 11)]
                  + np.asarray(lm.level_start)[None, :])
    return dict(lm=lm, jlm=jlm, graph=graph, jgraph=jgraph, edges=edges,
                feats=feats, eval_feats=eval_feats, eval_paths=eval_paths)


def test_fc7_epoch_and_eval_on_a_mesh(fc7, tmp_path):
    common = dict(energy="hyp_cone", embedding_dim=4, batch_size=8,
                  neg_to_pos_ratio=2, seed=0)
    jt = JaxJoint(fc7["jlm"], fc7["jgraph"], fc7["edges"], fc7["feats"],
                  JaxJointConfig(feature_dim=32, **common),
                  mesh=jax_make_mesh(n_data=2, n_model=1))
    params = jax.device_get(jt.params)
    weights = {"labels": label_table_from_jax(params["labels"]),
               "images": feat_net_from_jax(params["images"])}
    want_emb = np.asarray(jt.image_embeddings(fc7["eval_feats"]))
    cfg = JointTrainerConfig(feature_dim=32, device="cpu", **common)
    args = dict(labelmap=fc7["lm"], graph=fc7["graph"], edges=fc7["edges"],
                features=fc7["feats"], cfg=cfg,
                eval_features=fc7["eval_feats"],
                eval_paths=fc7["eval_paths"], weights=weights)
    # the eval embeddings of the JAX weights (no epoch), then an epoch
    res0 = run_ranks(PROGRAMS + "fc7_epochs", 2,
                     dict(n_data=2, epochs=0, **args),
                     workdir=str(tmp_path / "eval"), threads=1,
                     timeout_s=120)
    for r in res0:
        assert r["eval_embeddings"].shape == (11, 4)
        np.testing.assert_allclose(r["eval_embeddings"], want_emb,
                                   rtol=1e-5, atol=1e-6)
    one = fc7_run(epochs=2, **args)
    res = run_ranks(PROGRAMS + "fc7_epochs", 2, dict(n_data=2, epochs=2,
                                                     **args),
                    workdir=str(tmp_path / "train"), threads=1,
                    timeout_s=120)
    for r in res:
        for a, b in zip(r["stats"], one["stats"]):
            _stats_close(a, b)
        for part in ("labels", "images"):
            for k, v in r["params"][part].items():
                np.testing.assert_allclose(v, one["params"][part][k],
                                           rtol=1e-5, atol=1e-6)
                np.testing.assert_array_equal(v, res[0]["params"][part][k])
        np.testing.assert_allclose(r["eval_embeddings"],
                                   one["eval_embeddings"], rtol=1e-5,
                                   atol=1e-6)
        for k in ("hit@1", "micro_f1", "reconstruction_f1"):
            assert r[k] == pytest.approx(one[k], abs=1e-6), k


def test_indivisible_batches_raise(fc7):
    """The JAX trainers' error, before anything is built (a 2-shard Mesh
    object needs no process group for that)."""
    mesh = Mesh(2, 1, "cpu")
    lm, graph, edges = fc7["lm"], fc7["graph"], fc7["edges"]
    splits = split_edges(label_graph_from_paths(lm.leaf_paths(), lm),
                         seed=0)
    with pytest.raises(ValueError, match="must divide evenly over the "
                                         "mesh's 2 'data' shards"):
        EmbeddingTrainer(lm, splits, EmbeddingTrainerConfig(
            batch_size=7, device="cpu"), mesh=mesh)
    with pytest.raises(ValueError, match="divide evenly"):
        JointEmbeddingTrainer(lm, graph, edges, fc7["feats"],
                              JointTrainerConfig(feature_dim=32,
                                                 batch_size=7,
                                                 device="cpu"), mesh=mesh)
    with pytest.raises(ValueError, match="divide evenly"):
        JointCNNTrainer(lm, graph, edges, None, JointCNNConfig(
            backbone="resnet18", batch_size=7, device="cpu"), mesh=mesh)
    with pytest.raises(ValueError, match="the config asks for 'cuda'"):
        JointCNNTrainer(lm, graph, edges, None, JointCNNConfig(
            backbone="resnet18", batch_size=8), mesh=mesh)


def test_label_cli_data_parallel_in_ranks(tmp_path):
    """Under torchrun (``--standalone``: a free local port): the CLI starts
    its process group from the environment (``init_from_env``) and its
    runner's mesh="auto" takes both ranks; both print the same result."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2", "-m",
            "learning_embeddings_tpu_torch.cli.order_embeddings_h",
            "--taxonomy", "butterfly200", "--set_mode", "train",
            "--experiment_dir", str(tmp_path), "--experiment_name", "h",
            "--batch_size", "64", "--n_epochs", "2", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(argv, cwd=root, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    results = [x for x in proc.stdout.splitlines()
               if x.startswith("{'best_val_f1'")]
    assert len(results) == 2 and results[0] == results[1]
    for rel in ("config_params.txt", "weights/0", "weights/1",
                "weights/best_model", "logs/metrics.jsonl"):
        assert (tmp_path / "h" / rel).is_file(), rel
    steps = [x["step"] for x in _metrics(str(tmp_path / "h"))
             if x["tag"] == "train/loss"]
    assert steps == [0, 1]                  # written once, by rank 0


def _metrics(exp):
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]
