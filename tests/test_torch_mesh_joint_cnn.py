"""The ``--use_CNN`` joint step on a (2, 1) mesh of 2 gloo ranks, against
the JAX package's meshed step (JAX ``tests/test_joint_cnn.py:90-141``:
tower batch and edge slots over 'data', parameters replicated, the BN
statistics and the gradients reduced over the shards) and against the
port's one-device step, on the CPU: f32 ResNet-18@32 tower, the toy 2/4/8
taxonomy, 24 distinct images, 8 label→image edges a step, ratio 4, from
the JAX trainer's weights and the same host negatives. Then the tower's
warm start from a classifier trunk on the mesh, and the meshed eval:
embeddings of a ragged 11 rows in chunks of 4, hit@1 and the
reconstruction. Tolerances as ``tests/test_torch_joint_cnn.py``'s
one-device step against JAX (loss rel 2e-5, energies rtol 1e-4, the
label table atol 1e-6, running statistics 1e-5)."""

import numpy as np
import pytest
import torch

import jax

from learning_embeddings_tpu.parallel.mesh import make_mesh as jax_make_mesh
from learning_embeddings_tpu.train.joint_cnn import (
    JointCNNConfig as JaxConfig, JointCNNTrainer as JaxTrainer)
from learning_embeddings_tpu_torch.models import (
    label_table_from_jax, state_dict_from_jax)
from learning_embeddings_tpu_torch.parallel.launch import run_ranks
from learning_embeddings_tpu_torch.parallel.programs import joint_cnn_run
from learning_embeddings_tpu_torch.train.classifier import (
    ClassifierConfig, ClassifierTrainer)
from learning_embeddings_tpu_torch.train.joint_cnn import JointCNNConfig

from test_torch_joint_cnn import STAGES18, setup  # noqa: F401

torch.set_num_threads(2)
COMMON = dict(backbone="resnet18", embedding_dim=4, image_size=32,
              batch_size=8, neg_to_pos_ratio=4, alpha=0.5,
              tower_dtype="float32", lr_labels=1e-2, lr_images=1e-3, seed=0)


def test_use_cnn_step_on_a_mesh_matches_jax_and_one_device(setup,  # noqa
                                                           tmp_path):
    batch = setup["batch"]
    jt = JaxTrainer(setup["jlm"], setup["jgraph"], setup["edges"],
                    setup["loader"], JaxConfig(donate=False, **COMMON),
                    mesh=jax_make_mesh(n_data=2, n_model=1))
    params = jax.device_get(jt.params)
    weights = {"labels": {k: v.numpy() for k, v in label_table_from_jax(
                   params["labels"]).items()},
               "images": {k: v.numpy() for k, v in state_dict_from_jax(
                   params["images"], jax.device_get(jt.batch_stats),
                   STAGES18).items()}}
    jloss, jep, jen = jt.train_batch(batch[:, 0], batch[:, 1])
    jparams = jax.device_get(jt.params)
    jtable = np.asarray(jparams["labels"]["params"]["embedding"])
    jtower = state_dict_from_jax(jparams["images"],
                                 jax.device_get(jt.batch_stats), STAGES18)

    warm = ClassifierTrainer(setup["lm"], ClassifierConfig(
        backbone="resnet18", image_size=32, batch_size=4, seed=1,
        dtype=torch.float32, device="cpu")).model.trunk
    warm_trunk = ({k: v.detach().numpy()
                   for k, v in warm.named_parameters()},
                  {k: v.numpy() for k, v in warm.named_buffers()})
    bank = setup["loader"](np.arange(24))
    args = dict(labelmap=setup["lm"], graph=setup["graph"],
                edges=setup["edges"], bank=bank,
                cfg=JointCNNConfig(device="cpu", prefetch=False, **COMMON),
                batches=[(batch[:, 0], batch[:, 1])], weights=weights,
                eval_rows=np.arange(11), eval_batch_size=4,
                warm_trunk=warm_trunk)
    one = joint_cnn_run(**args)
    res = run_ranks("learning_embeddings_tpu_torch.parallel.programs:"
                    "joint_cnn_steps", 2, dict(n_data=2, **args),
                    workdir=str(tmp_path), threads=1, timeout_s=180)
    for r in res:
        step = r["steps"][0]
        assert step["loss"] == pytest.approx(float(jloss), rel=2e-5)
        assert step["loss"] == pytest.approx(one["steps"][0]["loss"],
                                             rel=1e-5)
        for got, want in ((step["e_pos"], jep), (step["e_neg"], jen)):
            want = np.asarray(want)
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=2e-4 * max(1.0,
                                                       np.abs(want).max()))
        np.testing.assert_allclose(r["labels"]["embedding"], jtable,
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["labels"]["embedding"],
                                   one["labels"]["embedding"], rtol=0,
                                   atol=1e-6)
        for k, v in r["images"].items():
            if "running" in k:
                np.testing.assert_allclose(v, jtower[k].numpy(), rtol=1e-5,
                                           atol=1e-5, err_msg=k)
                np.testing.assert_array_equal(v, res[0]["images"][k])
        # the tower's blocks run on their ranks: one gather a step, its
        # gradient summed back; the BN statistics of the global batch
        c = r["counts"]
        assert c["collective_tower_embeddings"] == 1
        assert c["collective_gather_rows_grad"] == 1
        assert c["collective_bn_stats"] == c["collective_bn_corr"] == 20
        # the warm start composes with the mesh
        assert r["warm_loss"] == pytest.approx(one["warm_loss"], rel=1e-5)
        # the meshed eval: ragged rows, sharded ranking and reconstruction
        # after two Adam steps a few trunk entries whose gradients are
        # within rounding of 0 moved by ±lr on the two runs
        # (tests/test_torch_joint_cnn.py), which the eval forward carries
        assert r["eval_embeddings"].shape == (11, 4)
        np.testing.assert_allclose(
            r["eval_embeddings"], one["eval_embeddings"], rtol=1e-4,
            atol=1e-4 * np.abs(one["eval_embeddings"]).max())
        assert r["hit@1"] == one["hit@1"]
        assert r["reconstruction_f1"] == pytest.approx(
            one["reconstruction_f1"], abs=1e-6)
        assert r["eval_counts"]["collective_pairwise_tiles"] == 2
