"""The classifier's BatchNorm routes and gradient accumulation on a (2, 1)
mesh of 2 gloo ranks, held against the port's one-device step (and, for
the ghost statistics, against the JAX package's meshed step): float32
ResNet-18@32, global batch 8 (4 rows a rank), the toy taxonomy,
multi_level_ce, Adam at lr 1e-3 from the JAX trainer's initial weights.

* grad_accum = 2: the gradients of two micro-batches are all-reduced once,
  at the update;
* ghost statistics over the first 2 rows of the global batch (all on rank
  0: rank 1 adds zeros and runs no K1) and over the first 6 (4 + 2);
* bf16 statistics, rounded after the all-reduce (bf16 tolerances, as the
  zoo's one-device tests: a mean that lands on the other side of a bf16
  rounding boundary moves a channel by a bf16 step);
* the flax route: the library's synchronised statistics (their plain
  equivalent on the CPU) against the library's BatchNorm on one device.

Every case: the loss within rtol 1e-5 (bf16: 2e-2), the head's kernel
within rtol 1e-4 / atol 1e-6 (bf16: looser), the running statistics equal
on both ranks bit for bit and equal to the one-device ones within rtol
1e-5 / atol 1e-6."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from learning_embeddings_tpu.hierarchy import toy_labelmap as jax_toy
from learning_embeddings_tpu.parallel.mesh import make_mesh as jax_make_mesh
from learning_embeddings_tpu.train.classifier import (
    ClassifierConfig as JaxConfig, ClassifierTrainer as JaxTrainer)
from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
from learning_embeddings_tpu_torch.parallel.launch import run_ranks
from learning_embeddings_tpu_torch.parallel.programs import classifier_run
from learning_embeddings_tpu_torch.train.classifier import ClassifierConfig

from test_torch_mesh_classifier import B, LR, SIZE, _batch, _jax_step

OPTIONS = {
    "grad_accum": dict(grad_accum=2),
    "ghost_rank0_only": dict(bn_stats_rows=2),
    "ghost_both_ranks": dict(bn_stats_rows=6),
    "bf16_statistics": dict(bn_stats_dtype="bfloat16"),
    "flax": dict(bn_impl="flax"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    lm = toy_labelmap(3, 3)
    start, _, _ = _jax_step("multi_level_ce", (3, 3), 2, 1)
    base = ClassifierConfig(backbone="resnet18", criterion="multi_level_ce",
                            lr=LR, image_size=SIZE, batch_size=B,
                            dtype=torch.float32, device="cpu")
    cases, one = {}, {}
    for name, kw in OPTIONS.items():
        n_batches = 2 if name == "grad_accum" else 1
        cases[name] = dict(labelmap=lm, cfg=dataclasses.replace(base, **kw),
                           batches=[_batch(lm, s) for s in range(n_batches)],
                           weights=start, state_keys=("fc.weight",))
        one[name] = classifier_run(**cases[name])
    res = run_ranks("learning_embeddings_tpu_torch.parallel.programs:"
                    "classifier_cases", 2,
                    dict(n_data=2, n_model=1, cases=list(cases.values())),
                    workdir=str(tmp_path_factory.mktemp("ranks")), threads=1,
                    timeout_s=240)
    return {name: ([r[i] for r in res], one[name])
            for i, name in enumerate(OPTIONS)}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_option_on_a_mesh_equals_one_device(runs, name):
    mine, one = runs[name]
    bf16 = name == "bf16_statistics"
    for r in mine:
        np.testing.assert_allclose(r["losses"], one["losses"],
                                   rtol=2e-2 if bf16 else 1e-5)
        np.testing.assert_allclose(
            r["state_dict"]["fc.weight"], one["state_dict"]["fc.weight"],
            rtol=1e-4, atol=3e-3 if bf16 else 1e-6)
        for k, v in r["running"].items():
            np.testing.assert_array_equal(v, mine[0]["running"][k])
            np.testing.assert_allclose(v, one["running"][k],
                                       rtol=2e-2 if bf16 else 1e-5,
                                       atol=1e-2 if bf16 else 1e-6,
                                       err_msg=k)
        c = r["counts"]
        steps = len(r["losses"])
        assert c["collective_bn_corr"] == 20 * steps
        # the flax route gathers each rank's (mean, invstd, count)
        assert c["collective_bn_stats"] == 20 * steps
        assert c["collective_grads"] == 1      # one update, grad_accum too


def test_ghost_prefix_of_the_global_batch_matches_jax(runs):
    """JAX's GSPMD GhostBatchNorm takes the statistics of the global
    batch's first rows: on the mesh and unsharded alike. Over 6 rows (4 on
    rank 0, 2 on rank 1); over 2 rows the statistics of two images at
    layer4's 1×1 map are ill-conditioned (the loss is ~7e4, and the JAX
    package's own meshed and unsharded steps differ by 1.1% there), so
    that case is held to the port's one-device step only."""
    jlm = jax_toy(3, 3)
    for name, rows in (("ghost_both_ranks", 6),):
        cfg = JaxConfig(backbone="resnet18", criterion="multi_level_ce",
                        lr=LR, image_size=SIZE, batch_size=B, seed=0,
                        dtype=jnp.float32, donate=False, bn_stats_rows=rows)
        tr = JaxTrainer(jlm, cfg, mesh=jax_make_mesh(n_data=2, n_model=1))
        st, loss = tr.train_step(tr.state, *tr.put_batch(*_batch(jlm, 0)))
        for r in runs[name][0]:
            np.testing.assert_allclose(r["losses"][0], float(loss),
                                       rtol=1e-5)
            np.testing.assert_allclose(
                r["state_dict"]["fc.weight"].T,
                np.asarray(st.params["fc"]["kernel"]), rtol=1e-4, atol=1e-6)
