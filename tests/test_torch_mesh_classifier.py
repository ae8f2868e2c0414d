"""The port's meshed classifier step against the JAX package's meshed step
(GSPMD) and against the port's own one-device step, on the CPU, float32
ResNet-18@32, batch 8, one Adam step at lr 1e-3 from the JAX trainer's
initial weights: every criterion on a (2, 1) mesh of 2 gloo ranks and on
a (2, 2) mesh of 4, where the head is tensor-parallel (row-parallel for
the toy taxonomy's odd 39 classes, column-parallel for an even 14).
Tolerances are the JAX tests' own (``tests/test_classifier.py:56-70``,
``:255-287``): the loss within rtol 1e-5, the head's kernel within rtol
1e-4 / atol 1e-6, the TP head's loss within 1e-4. ``masked_ce``'s loss is
the batch sum, so its gradients are summed over the shards: its step
equals the unsharded one only if they are. The running statistics are
equal on every rank, bit for bit, and the eval scores of the global batch
come back whole."""

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
from learning_embeddings_tpu_torch.parallel.launch import run_ranks
from learning_embeddings_tpu_torch.parallel.programs import classifier_run
from learning_embeddings_tpu_torch.train.classifier import ClassifierConfig

torch.set_num_threads(2)
B, SIZE, LR = 8, 32, 1e-3
STAGES18 = (2, 2, 2, 2)
CRITERIA = ("multi_level_ce", "last_level_ce", "masked_ce",
            "multi_label_sm", "hsoftmax")


def _batch(lm, seed):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)
    ll = lm.leaf_paths()[rng.randint(0, lm.levels[-1], B)].astype(np.int32)
    mh = np.zeros((B, lm.n_classes), np.float32)
    mh[np.arange(B)[:, None], ll + np.asarray(lm.level_start)] = 1.0
    return imgs, ll, mh


def _jax_step(criterion, levels, n_data, n_model):
    """The JAX meshed step: its start (as a port state dict), its loss,
    its head kernel after the step."""
    jlm = jax_toy(*levels)
    cfg = JaxConfig(backbone="resnet18", criterion=criterion, lr=LR,
                    image_size=SIZE, batch_size=B, seed=0,
                    dtype=jnp.float32, donate=False)
    tr = JaxTrainer(jlm, cfg, mesh=jax_make_mesh(n_data=n_data,
                                                 n_model=n_model))
    start = state_dict_from_jax(
        jax.device_get(tr.state.params), jax.device_get(tr.state.batch_stats),
        STAGES18)
    st, loss = tr.train_step(tr.state, *tr.put_batch(*_batch(jlm, 0)))
    kernel = np.asarray(st.params["fc"]["kernel"])
    return {k: v.numpy() for k, v in start.items()}, float(loss), kernel


def _cases(n_data, n_model, specs):
    """JAX results, port one-device results and the port ranks' case
    list for (criterion, taxonomy levels) `specs`."""
    jax_out, one, cases = [], [], []
    for criterion, levels in specs:
        lm = toy_labelmap(*levels)
        start, jloss, jkernel = _jax_step(criterion, levels, n_data,
                                          n_model)
        cfg = ClassifierConfig(backbone="resnet18", criterion=criterion,
                               lr=LR, image_size=SIZE, batch_size=B,
                               dtype=torch.float32, device="cpu")
        kw = dict(labelmap=lm, cfg=cfg, batches=[_batch(lm, 0)],
                  weights=start, eval_batch=_batch(lm, 1),
                  state_keys=("fc.weight",))
        jax_out.append((jloss, jkernel))
        one.append(classifier_run(**kw))
        cases.append(kw)
    return jax_out, one, cases


def _check(res, jax_out, one, specs, tp_tol=None):
    for i, (criterion, _) in enumerate(specs):
        jloss, jkernel = jax_out[i]
        mine = [r[i] for r in res]
        for r in mine:
            loss = r["losses"][0]
            if tp_tol is None:
                np.testing.assert_allclose(loss, jloss, rtol=1e-5,
                                           err_msg=criterion)
            else:
                assert abs(loss - jloss) < tp_tol, (criterion, loss, jloss)
            np.testing.assert_allclose(loss, one[i]["losses"][0], rtol=1e-5,
                                       err_msg=criterion)
            kernel = r["state_dict"]["fc.weight"].T
            np.testing.assert_allclose(kernel, jkernel, rtol=1e-4,
                                       atol=1e-6, err_msg=criterion)
            np.testing.assert_allclose(
                r["state_dict"]["fc.weight"],
                one[i]["state_dict"]["fc.weight"], rtol=1e-4, atol=1e-6)
            # the global batch's scores at the start, whole on every rank
            assert r["eval_scores"].shape == one[i]["eval_scores"].shape
            np.testing.assert_allclose(
                r["eval_scores"], one[i]["eval_scores"], rtol=0,
                atol=1e-5 * np.abs(one[i]["eval_scores"]).max())
            # running statistics: the global batch's, equal on every rank
            for k, v in r["running"].items():
                np.testing.assert_array_equal(v, mine[0]["running"][k])
                np.testing.assert_allclose(v, one[i]["running"][k],
                                           rtol=1e-5, atol=1e-6, err_msg=k)


def test_dp_step_all_criteria_match_jax_and_one_device(tmp_path):
    specs = [(c, (3, 3)) for c in CRITERIA]
    jax_out, one, cases = _cases(2, 1, specs)
    res = run_ranks("learning_embeddings_tpu_torch.parallel.programs:"
                    "classifier_cases", 2,
                    dict(n_data=2, n_model=1, cases=cases),
                    workdir=str(tmp_path), threads=1, timeout_s=240)
    _check(res, jax_out, one, specs)
    for r in res:
        c = r[0]["counts"]
        # one all-reduce per BN layer and pass, one for the gradients
        assert c["collective_bn_stats"] == c["collective_bn_corr"] == 20
        assert c["collective_grads"] == 1
        assert "collective_copy_to_group_grad" not in c
