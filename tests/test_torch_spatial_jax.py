"""The JAX oracle of spatial partitioning (JAX
``tests/test_classifier.py:289-309``): ResNet-18@32, float32, batch 8,
``spatial_partition=True`` on a (2, 4) mesh, one Adam step at lr 1e-3
from the JAX trainer's initial weights. The JAX side runs its own GSPMD
step on its (2, 4) mesh of 8 host devices; the port runs on 8 gloo ranks,
where layer2 leaves one row a rank and layer3's stride-2 block gathers H
whole. Tolerances: the JAX test's own for the loss (1e-4, against JAX and
against the port's one-device step) and
``tests/test_torch_mesh_classifier.py``'s for the head's kernel (rtol
1e-4, atol 1e-6); the eval scores within 1e-5 of their largest entry and
the running statistics within rtol 1e-5 / atol 1e-6 of one device's,
and equal on every rank bit for bit."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from learning_embeddings_tpu.hierarchy import toy_labelmap as jax_toy
from learning_embeddings_tpu.parallel.mesh import make_mesh as jax_make_mesh
from learning_embeddings_tpu.train.classifier import (
    ClassifierConfig as JaxConfig, ClassifierTrainer as JaxTrainer)
from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
from learning_embeddings_tpu_torch.models import state_dict_from_jax
from learning_embeddings_tpu_torch.models.resnet import (make_trunk,
                                                         spatial_halo_counts)
from learning_embeddings_tpu_torch.parallel.launch import run_ranks
from learning_embeddings_tpu_torch.parallel.programs import classifier_run
from learning_embeddings_tpu_torch.train.classifier import ClassifierConfig

torch.set_num_threads(2)
B, SIZE, LR = 8, 32, 1e-3
N_DATA, N_MODEL = 2, 4


def _batch(lm, seed):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)
    ll = lm.leaf_paths()[rng.randint(0, lm.levels[-1], B)].astype(np.int32)
    mh = np.zeros((B, lm.n_classes), np.float32)
    mh[np.arange(B)[:, None], ll + np.asarray(lm.level_start)] = 1.0
    return imgs, ll, mh


def test_spatial_step_on_2x4_matches_jax_and_one_device(tmp_path):
    jlm = jax_toy(3, 3)
    jcfg = JaxConfig(backbone="resnet18", criterion="multi_level_ce", lr=LR,
                     image_size=SIZE, batch_size=B, seed=0,
                     dtype=jnp.float32, spatial_partition=True,
                     donate=False)
    jtr = JaxTrainer(jlm, jcfg, mesh=jax_make_mesh(n_data=N_DATA,
                                                   n_model=N_MODEL))
    start = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.device_get(jtr.state.params),
        jax.device_get(jtr.state.batch_stats), (2, 2, 2, 2)).items()}
    batch = jtr.put_batch(*_batch(jlm, 0))
    assert tuple(batch[0].sharding.spec) == ("data", "model")
    st, jloss = jtr.train_step(jtr.state, *batch)
    jkernel = np.asarray(st.params["fc"]["kernel"])

    lm = toy_labelmap(3, 3)
    cfg = ClassifierConfig(backbone="resnet18", criterion="multi_level_ce",
                           lr=LR, image_size=SIZE, batch_size=B,
                           dtype=torch.float32, spatial_partition=True,
                           device="cpu")
    kw = dict(labelmap=lm, cfg=cfg, batches=[_batch(lm, 0)], weights=start,
              eval_batch=_batch(lm, 1), state_keys=("fc.weight",))
    one = classifier_run(**kw)
    res = run_ranks("learning_embeddings_tpu_torch.parallel.programs:"
                    "classifier_cases", N_DATA * N_MODEL,
                    dict(n_data=N_DATA, n_model=N_MODEL, cases=[kw]),
                    workdir=str(tmp_path), threads=1, timeout_s=300)
    halos = spatial_halo_counts(make_trunk("resnet18"), SIZE, N_MODEL)
    assert halos == {"halo": 10, "halo_grad": 9}
    scale = np.abs(one["eval_scores"]).max()
    for (r,) in res:
        loss = r["losses"][0]
        assert abs(loss - float(jloss)) < 1e-4, (loss, float(jloss))
        assert abs(loss - one["losses"][0]) < 1e-4, (loss, one["losses"])
        kernel = r["state_dict"]["fc.weight"].T
        np.testing.assert_allclose(kernel, jkernel, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(r["state_dict"]["fc.weight"],
                                   one["state_dict"]["fc.weight"],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(r["eval_scores"], one["eval_scores"],
                                   rtol=0, atol=1e-5 * scale)
        assert abs(r["eval_loss"] - one["eval_loss"]) < 1e-4
        for k, v in r["running"].items():
            np.testing.assert_array_equal(v, res[0][0]["running"][k])
            np.testing.assert_allclose(v, one["running"][k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        c = r["counts"]
        assert (c["collective_halo"], c["collective_halo_grad"]) == (10, 9)
        assert c["collective_gather_height"] == 1      # at layer3
        # the head row-parallel over 'model' (512 / 4; 39 classes), as
        # JAX's P("model", None)
        assert c["collective_reduce_from_group"] == 1
        assert c["collective_grads_model"] == c["collective_grads"] == 1
